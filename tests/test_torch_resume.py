"""A resumed run equals an uninterrupted one: `latest` carries the plateau
machine's two snapshots (`latest.snap.pt`), so a halving after `--resume`
restores what it would have restored without the interruption.

The schedule halves every second epoch (dropout 0, no weight noise,
end_adjust_acc far above any dev loss, plateau_patience 2,
checkpoint_every 1) and restores a state older than the kill (SEEN_LOSS
says why); 6 epochs in one `fit` against 3 + a fresh Trainer
with resume=True to 6, on the CPU at a tiny width.  Bit for bit: the
dropout and weight-noise generators restart from the seed on a resume
(as mdd_tpu's do), which is why the equality is claimed at dropout 0 and
without weight noise only.  mdd_tpu's `latest` has no snapshots; the
port's is a deliberate divergence.
"""

import json

import pytest
import torch

from mdd_tpu_torch import cli
from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.train.checkpoint import load_checkpoint, load_snapshots
from mdd_tpu_torch.train.plateau import PlateauAction
from mdd_tpu_torch.utils.config import load_config
from test_torch_data import UNITS, write_corpus

EPOCHS, KILL = 6, 3
# what the plateau machine is fed, by epoch: a dev loss that rises every
# epoch, so no epoch after the first takes a new restore point and each
# halving (epochs 2, 4, 6) restores epoch 1's state; a dev acc that peaks
# at epoch 2, so `best` is a state taken before the kill.  The real dev
# loss falls every epoch on this corpus, and then each halving restores
# the snapshot its own epoch has just taken: a resume that lost the
# snapshots would show nothing.
SEEN_LOSS = {e: 100.0 + e for e in range(1, EPOCHS + 1)}
SEEN_ACC = {1: 0.1, 2: 0.3, 3: 0.2, 4: 0.25, 5: 0.2, 6: 0.1}


def _conf(root, name):
    train = write_corpus(root / "data", "train", 10, seed=1, frames=(6, 10))
    dev = write_corpus(root / "data", "dev", 4, seed=2, frames=(6, 10))
    (root / "units").write_text("\n".join(UNITS) + "\n")
    fields = dict(
        exp_name=name, checkpoint_dir=str(root / "ckpt"), seed=3,
        vocab_file=str(root / "units"),
        train_scp_path=train[0], train_lab_path=train[1],
        train_trans_path=train[2], valid_scp_path=dev[0],
        valid_lab_path=dev[1], valid_trans_path=dev[2],
        rnn_hidden_size=16, rnn_layers=2, channel="[(1, 4), (4, 4)]",
        use_pallas_lstm=True, device_frontend=True, wire_dtype="bfloat16",
        batch_size=4, verbose_step=100, num_workers=0, time_quantum=8,
        label_quantum=4, drop_out=0.0, end_adjust_acc=1000.0,
        plateau_patience=2, checkpoint_every=1, init_lr=0.003)
    path = root / f"{name}.yaml"
    path.write_text("".join(f"{k}: {json.dumps(v)}\n"
                            for k, v in fields.items()))
    return load_config(str(path))


def _fit(cfg, epochs, resume=False):
    """`train` as cmd_train runs it, to `epochs`, its plateau machine fed
    SEEN_LOSS and SEEN_ACC; -> (summary, the plateau actions by epoch, the
    first state _restore_snapshot installed in each epoch, the log
    lines)."""
    vocab = Vocab.from_units_file(cfg.vocab_file)
    trainer = cli.build_trainer(cfg, vocab, "cpu")
    loaders = [cli._build_loader(cfg, vocab, *paths, train=train,
                                 device="cpu")
               for paths, train in (
                   ((cfg.train_scp_path, cfg.train_lab_path,
                     cfg.train_trans_path), True),
                   ((cfg.valid_scp_path, cfg.valid_lab_path,
                     cfg.valid_trans_path), False))]
    actions, installed, lines = {}, {}, []
    step, restore = trainer.scheduler.step, trainer._restore_snapshot

    def record_step(dev_loss, acc):
        epoch = len(trainer.dev_loss_results)
        actions[epoch] = step(SEEN_LOSS[epoch], SEEN_ACC[epoch])
        return actions[epoch]

    def record_restore(snap):
        restore(snap)
        installed.setdefault(len(trainer.dev_loss_results), {
            k: v.clone() for k, v in trainer.model.state_dict().items()})

    trainer.scheduler.step = record_step
    trainer._restore_snapshot = record_restore
    summary = trainer.fit(*loaders, num_epochs=epochs,
                          print_every=cfg.verbose_step,
                          checkpoint_dir=cfg.checkpoint_dir,
                          exp_name=cfg.exp_name, log=lines.append,
                          resume=resume,
                          checkpoint_every=cfg.checkpoint_every)
    return summary, actions, installed, lines


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    whole = _fit(_conf(root, "whole"), EPOCHS)
    split_cfg = _conf(root, "split")
    first = _fit(split_cfg, KILL)
    ckpt = f"{split_cfg.checkpoint_dir}/split"
    at_kill = load_snapshots(ckpt, "latest")
    resumed = _fit(split_cfg, EPOCHS, resume=True)
    return root, whole, first, resumed, at_kill


def _best(root, name):
    return load_checkpoint(str(root / "ckpt" / name), "best")[0]


def test_resumed_run_equals_uninterrupted_run(runs):
    root, whole, first, resumed, _ = runs
    (s_whole, a_whole, _, _), (s_res, a_res, _, lines) = whole, resumed
    assert (f"resumed from epoch {KILL} (lr 0.00150) of the port's "
            "latest.pt") in lines
    # the schedule halves and restores at epochs 2, 4 and 6; only epoch 1
    # takes a restore point, and `best` is epoch 2's state
    restore, snap = PlateauAction.DECAY_AND_RESTORE, PlateauAction.SNAPSHOT_LOSS
    assert [e for e, a in a_whole.items() if a & restore] == [2, 4, 6]
    assert [e for e, a in a_whole.items() if a & snap] == [1]
    assert a_res == {e: a for e, a in a_whole.items() if e > KILL}
    assert {e: a for e, a in first[1].items()} == {
        e: a for e, a in a_whole.items() if e <= KILL}
    for key in ("loss_results", "dev_loss_results", "dev_acc_results"):
        assert s_res[key] == s_whole[key], key          # bit for bit
    assert (s_res["best_dev_loss"], s_res["best_acc"], s_res["epochs"]) == (
        s_whole["best_dev_loss"], s_whole["best_acc"], EPOCHS)
    assert s_res["best_acc"] == SEEN_ACC[2]
    best_whole, best_res = _best(root, "whole"), _best(root, "split")
    assert best_whole.keys() == best_res.keys()
    for k in best_whole:
        assert torch.equal(best_whole[k], best_res[k]), k


def test_first_restore_after_resume_installs_latests_snapshot(runs):
    """The halving of epoch 4 installs the `_snapshot` that `latest` held
    at epoch 3 (epoch 1's state), bit for bit, as the uninterrupted run
    does."""
    _, whole, _, resumed, at_kill = runs
    assert at_kill is not None and at_kill["snapshot"] is not None
    assert at_kill["best_acc_state"] is not None
    first_after = min(e for e in resumed[2] if e > KILL)
    assert first_after == KILL + 1
    got, want = resumed[2][first_after], whole[2][first_after]
    snap_model = at_kill["snapshot"][0]
    for k in snap_model:
        assert torch.equal(got[k], snap_model[k]), k
        assert torch.equal(want[k], snap_model[k]), k


def test_latest_carries_both_snapshots_with_the_meta_renamed_last(runs):
    root, *_ = runs
    ckpt = root / "ckpt" / "split"
    names = sorted(p.name for p in ckpt.iterdir())
    assert names == ["best.meta.json", "best.pt", "latest.meta.json",
                     "latest.opt.pt", "latest.pt", "latest.snap.pt"]
    snaps = torch.load(ckpt / "latest.snap.pt", weights_only=True)
    for key in ("snapshot", "best_acc_state"):
        model_state, opt_state = snaps[key]
        assert set(model_state) == set(_best(root, "split"))
        assert any(k.endswith(".mean") for k in model_state)   # BN stats
        assert all("exp_avg_sq" in s for s in opt_state["state"].values())


def test_latest_without_snapshots_still_resumes(tmp_path):
    """A `latest` written before the snapshots were saved loads as it did,
    and says once that it has none."""
    cfg = _conf(tmp_path, "old")
    _fit(cfg, 2)
    (tmp_path / "ckpt" / "old" / "latest.snap.pt").unlink()
    summary, actions, _, lines = _fit(cfg, 3, resume=True)
    assert "resumed from epoch 2 (lr 0.00150) of the port's latest.pt" in lines
    assert sum("has no plateau snapshots" in line for line in lines) == 1
    assert summary["epochs"] == 3 and len(summary["loss_results"]) == 3
    assert list(actions) == [3]
    assert PlateauAction.SNAPSHOT_ACC not in actions[3]    # 0.2 < 0.3
