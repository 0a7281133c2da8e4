"""The port takes over an mdd_tpu training run: `train --resume` on
mdd_tpu's orbax `latest` restores its weights and optax's Adam state
(convert.optax_adam_to_torch), continues the run as mdd_tpu would, and
keeps writing it in mdd_tpu's format (train/orbax_format.py's writer), so
that mdd_tpu can take it back.

One model (the YAML's: 81 x 3 inputs, 2 conv x 4, 2 BiLSTM x 16, text
attention, dropout 0) on the CPU.  mdd_tpu's Trainer is built once and
compiled once (its plain LSTM: the Pallas one would run in interpret
mode); its later runs reuse it with its in-memory snapshots cleared, which
is what a fresh Trainer holds.

Tolerances (the North star's float32 ones): 1e-5 relative for a forward
from the same weights, atol 1e-4 / rtol 1e-3 for what the resumed Adam
steps make.  Near-zero gradients (the convolution biases sit before a
train-mode BatchNorm, so their gradient is 0 up to rounding) leave Adam's
step there at about lr * sign(noise), which the packages need not share:
parameters are compared where the bias-corrected first moment is clear
of that (GRAD_CLEAR), the moments everywhere, and the running mean that a
convolution's BatchNorm keeps, which follows the convolution's bias,
within the 2 lr a step the bias may drift.
"""

import dataclasses
import json
import os
import shutil
from pathlib import Path

import jax
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from mdd_tpu.data.dataset import Batch as JaxBatch
from mdd_tpu.models.ctc_model import ModelConfig as JaxConfig
from mdd_tpu.train import checkpoint as jax_checkpoint
from mdd_tpu.train.loop import Trainer as JaxTrainer
from mdd_tpu_torch import cli
from mdd_tpu_torch.convert import (flax_to_torch, optax_adam_to_torch,
                                   torch_adam_to_optax, torch_to_flax)
from mdd_tpu_torch.data.dataset import Batch
from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.train.checkpoint import (checkpoint_format,
                                            load_optimizer_state,
                                            load_snapshots)
from mdd_tpu_torch.train.orbax_format import (OrbaxFormatError,
                                              read_orbax_checkpoint,
                                              write_orbax_checkpoint)
from mdd_tpu_torch.utils.config import load_config
from test_torch_data import FEAT_DIM, UNITS, write_corpus

FWD_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
GRAD_CLEAR = 1e-3      # |first moment / (1 - b1^t)| above which a step's
# sign, and so the parameter, is set by the gradient and not its rounding
WD, LR = 5e-4, 1e-3
B1, B2 = 0.9, 0.999
EXP = "exp"
RESUMED_STEPS = 4       # epochs 2 and 3, 2 train batches each


def _leaves(tree, path=()):
    """(path, leaf) of a nested dict / list tree, sorted by path."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def _same_tree(a, b) -> None:
    """Equal structure, dtypes, shapes and bytes."""
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if x is None or y is None:
            assert x is None and y is None, path
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert (x.dtype, x.shape) == (y.dtype, y.shape), path
        assert x.tobytes() == y.tobytes(), path


def _yaml(root: Path, epochs: int) -> str:
    train = write_corpus(root / "data", "train", 10, seed=1, frames=(6, 10))
    dev = write_corpus(root / "data", "dev", 4, seed=2, frames=(6, 10))
    (root / "units").write_text("\n".join(UNITS) + "\n")
    fields = dict(
        exp_name=EXP, checkpoint_dir=str(root / "ckpt"), seed=3,
        vocab_file=str(root / "units"),
        train_scp_path=train[0], train_lab_path=train[1],
        train_trans_path=train[2], valid_scp_path=dev[0],
        valid_lab_path=dev[1], valid_trans_path=dev[2],
        rnn_hidden_size=16, rnn_layers=2, channel="[(1, 4), (4, 4)]",
        use_pallas_lstm=True, device_frontend=True, wire_dtype="bfloat16",
        batch_size=4, num_epoches=epochs, verbose_step=100, num_workers=0,
        time_quantum=8, label_quantum=4, drop_out=0.0, init_lr=LR,
        weight_decay=WD)
    path = root / f"train{epochs}.yaml"
    path.write_text("".join(f"{k}: {json.dumps(v)}\n"
                            for k, v in fields.items()))
    return str(path)


def _batches(rng, cfg, n, b=3, t=24, l=4):
    """`n` batches of host-spliced rows, as (mdd_tpu's, the port's)."""
    out = []
    for _ in range(n):
        arrays = (
            rng.standard_normal((b, t, cfg.input_dim)).astype(np.float32),
            np.asarray([1.0, 0.875, 0.75], np.float32)[:b],
            rng.integers(2, cfg.num_class, (b, l)).astype(np.int32),
            np.full(b, l, np.int32),
            rng.integers(2, cfg.num_class, (b, l)).astype(np.int32),
            np.full(b, l, np.int32), [f"u{i}" for i in range(b)])
        out.append((JaxBatch(*arrays), Batch(*arrays)))
    return out


class World:
    """The YAML, the model config, mdd_tpu's Trainer and the batches."""

    def __init__(self, root: Path):
        self.root = root
        self.conf = _yaml(root, 1)
        cfg = load_config(self.conf)
        self.vocab = Vocab.from_units_file(cfg.vocab_file)
        self.cfg = cfg
        self.model_cfg = cfg.model_config(self.vocab.n_words)
        jcfg = JaxConfig(**dict(dataclasses.asdict(self.model_cfg),
                                use_pallas_lstm=False))
        self.jax = JaxTrainer(jcfg, n_devices=1, sample_t=12, sample_l=4,
                              init_lr=LR, weight_decay=WD, seed=0)
        rng = np.random.default_rng(0)
        self.train = _batches(rng, self.model_cfg, 2)
        self.dev = _batches(rng, self.model_cfg, 1)

    def jax_fit(self, directory: Path, epochs: int, resume: bool):
        """mdd_tpu's fit, its Trainer as a fresh one would be."""
        t = self.jax
        t._snapshot = t._best_acc_state = None
        lines = []
        summary = t.fit([j for j, _ in self.train], [j for j, _ in self.dev],
                        num_epochs=epochs, checkpoint_dir=str(directory),
                        exp_name=EXP, log=lines.append, resume=resume,
                        checkpoint_every=1)
        return summary, lines

    def port_trainer(self):
        return cli.build_trainer(self.cfg, self.vocab, "cpu")

    def port_fit(self, directory: Path, epochs: int, trainer=None):
        t = trainer or self.port_trainer()
        t.device_frontend = False         # the batches are host-spliced
        lines = []
        summary = t.fit([p for _, p in self.train], [p for _, p in self.dev],
                        num_epochs=epochs, checkpoint_dir=str(directory),
                        exp_name=EXP, log=lines.append, resume=True,
                        checkpoint_every=1)
        return t, summary, lines


def _copy(src: Path, dst: Path) -> Path:
    shutil.copytree(src, dst)
    return dst


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """mdd_tpu trains 1 epoch (`latest` and `best` at epoch 1, in
    `epoch1/`); then mdd_tpu (in `jax3/`) and the port (in `port3/`)
    resume from copies of those files to epoch 3."""
    root = tmp_path_factory.mktemp("resume_mdd_tpu")
    w = World(root)
    w.jax_fit(root / "epoch1", 1, resume=False)
    w.epoch1 = root / "epoch1"
    w.jax3 = w.jax_fit(_copy(w.epoch1, root / "jax3"), 3, resume=True)
    w.port3 = w.port_fit(_copy(w.epoch1, root / "port3"), 3)
    return w


def test_fit_resumes_from_mdd_tpus_latest_alone(world):
    """(1) A directory with only mdd_tpu's files: the port resumes at
    their epoch, not at epoch 1 from seeded weights."""
    names = sorted(os.listdir(world.epoch1 / EXP))
    assert names == ["best", "best.meta.json", "latest", "latest.meta.json"]
    _, summary, lines = world.port3
    assert ("resumed from epoch 1 (lr 0.00100) of mdd_tpu's orbax latest/"
            in lines)
    assert "Start training epoch: 1, learning_rate: 0.00100" not in lines
    assert summary["epochs"] == 3 and len(summary["loss_results"]) == 3
    meta = json.loads((world.epoch1 / EXP / "latest.meta.json").read_text())
    assert summary["loss_results"][0] == meta["loss_results"][0]
    assert sum("has no plateau snapshots of its epoch 1" in line
               for line in lines) == 1


def test_optax_state_maps_to_torch_adam_and_back_bit_for_bit(world):
    """(2) mdd_tpu's own `latest`: optax tree -> torch Adam (loaded into a
    torch.optim.Adam) -> optax tree is the identity."""
    tree = read_orbax_checkpoint(str(world.epoch1 / EXP / "latest"))
    opt = tree["opt_state"]
    trainer = world.port_trainer()
    model = trainer.model
    sd = optax_adam_to_torch(opt, model, WD)
    adam = opt["inner_state"][1]
    mu = flax_to_torch(adam["mu"], tree["batch_stats"])
    nu = flax_to_torch(adam["nu"], tree["batch_stats"])
    names = [n for n, _ in model.named_parameters()]
    assert sorted(sd["state"]) == list(range(len(names)))
    for i, name in enumerate(names):
        s = sd["state"][i]
        assert torch.equal(s["exp_avg"], mu[name]), name
        assert torch.equal(s["exp_avg_sq"], nu[name]), name
        assert s["step"].dtype == torch.float32
        assert s["step"].device.type == "cpu"
        assert s["step"].item() == int(opt["count"]) == 2   # 2 steps
    group = sd["param_groups"][0]
    assert group["lr"] == float(opt["hyperparams"]["learning_rate"])
    assert (group["betas"], group["eps"], group["weight_decay"]) == (
        (0.9, 0.999), 1e-8, WD)
    trainer.optimizer.load_state_dict(sd)
    _same_tree(torch_adam_to_optax(trainer.optimizer, model), opt)
    _same_tree(torch_adam_to_optax(sd, model), opt)
    # the weights' inverse bridge too
    params, stats = torch_to_flax(flax_to_torch(tree["params"],
                                                tree["batch_stats"]))
    _same_tree({"params": params, "batch_stats": stats},
               {"params": tree["params"], "batch_stats": tree["batch_stats"]})


def _read(directory: Path, tag: str = "latest"):
    tree = read_orbax_checkpoint(str(directory / EXP / tag))
    meta = json.loads((directory / EXP / f"{tag}.meta.json").read_text())
    return tree, meta


def test_port_continues_mdd_tpus_run_as_mdd_tpu_does(world):
    """(3) From mdd_tpu's epoch-1 `latest`, mdd_tpu and the port each train
    epochs 2 and 3 on the same batches: the epochs' train and dev losses,
    the scheduler, and `latest` at epoch 3 (Adam's moments, counts, rate,
    BN statistics, parameters) agree."""
    (j_sum, j_lines), (_, p_sum, p_lines) = world.jax3, world.port3
    assert "resumed from epoch 1 (lr 0.00100)" in j_lines
    for key in ("loss_results", "dev_loss_results", "dev_acc_results"):
        np.testing.assert_allclose(p_sum[key], j_sum[key], err_msg=key,
                                   **GRAD_TOL)
    # the epoch-1 values come from the meta, alike in both
    assert p_sum["loss_results"][0] == j_sum["loss_results"][0]
    (jt, jm), (pt, pm) = _read(world.root / "jax3"), _read(
        world.root / "port3")
    assert jm["epoch"] == pm["epoch"] == 3
    assert jm["scheduler"].keys() == pm["scheduler"].keys()
    for key, want in jm["scheduler"].items():      # the best losses are
        got = pm["scheduler"][key]                 # losses, the rest exact
        if isinstance(want, float) and key.startswith("loss"):
            np.testing.assert_allclose(got, want, err_msg=key, **GRAD_TOL)
        else:
            assert got == want, key
    jo, po = jt["opt_state"], pt["opt_state"]
    assert int(jo["count"]) == int(po["count"]) == 6
    assert int(po["inner_state"][1]["count"]) == 6
    assert po["hyperparams"]["learning_rate"] == jo["hyperparams"][
        "learning_rate"]
    bc1, bc2 = 1 - B1 ** 6, 1 - B2 ** 6
    j_mu, p_mu = (flax_to_torch(o["inner_state"][1]["mu"], jt["batch_stats"])
                  for o in (jo, po))
    j_nu, p_nu = (flax_to_torch(o["inner_state"][1]["nu"], jt["batch_stats"])
                  for o in (jo, po))
    j_w = flax_to_torch(jt["params"], jt["batch_stats"])
    p_w = flax_to_torch(pt["params"], pt["batch_stats"])
    clear_share = []
    for name in (n for n in j_mu if not n.endswith((".mean", ".var"))):
        m_j, m_p = j_mu[name].numpy() / bc1, p_mu[name].numpy() / bc1
        np.testing.assert_allclose(m_p, m_j, err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(np.sqrt(p_nu[name].numpy() / bc2),
                                   np.sqrt(j_nu[name].numpy() / bc2),
                                   err_msg=name, **GRAD_TOL)
        clear = (np.abs(m_j) > GRAD_CLEAR) & (np.abs(m_p) > GRAD_CLEAR)
        clear_share.append(clear.mean())
        np.testing.assert_allclose(p_w[name].numpy()[clear],
                                   j_w[name].numpy()[clear], err_msg=name,
                                   **GRAD_TOL)
    assert np.mean(clear_share) > 0.5        # most entries are compared
    for name in (n for n in j_w if n.endswith((".mean", ".var"))):
        got, want = p_w[name].numpy(), j_w[name].numpy()
        if name.startswith("conv.bn") and name.endswith(".mean"):
            # the running mean of a convolution's output holds its bias,
            # which each resumed step may move 2 lr apart (the rule above)
            drift = 2 * LR * RESUMED_STEPS
            assert np.abs(got - want).max() <= drift + GRAD_TOL["atol"], name
        else:
            np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)


def test_restored_weights_give_mdd_tpus_forward(world):
    """(3) The forward from the restored epoch-1 weights: the port's dev
    loss against mdd_tpu's, within the forward tolerance."""
    trainer = world.port_trainer()
    trainer.device_frontend = False
    trainer.restore(str(world.epoch1), EXP, "latest", log=lambda *_: None)
    _, batch = world.dev[0]
    got = trainer.eval_step(trainer.batch_arrays(batch), torch.zeros(4))
    jt = world.jax
    jt.restore(str(world.epoch1), EXP, "latest")
    want = jt.run_epoch([world.dev[0][0]], 1, False, log=lambda *_: None)
    assert got[0].item() == pytest.approx(want[1], rel=FWD_RTOL)


@pytest.fixture(scope="module")
def handed_back(world):
    """mdd_tpu takes the port's run back: it resumes from the port's
    epoch-3 files (in `back/`) to epoch 4."""
    back = _copy(world.root / "port3", world.root / "back")
    summary, lines = world.jax_fit(back, 4, resume=True)
    return back, summary, lines


def test_mdd_tpu_restores_what_the_port_writes(world, handed_back):
    """(4) The port's `latest`, restored by mdd_tpu's load_checkpoint with
    and without a target, equals what the port's trainer held, bit for
    bit, and mdd_tpu's fit continues from it."""
    trainer = world.port3[0]
    path = world.root / "port3" / EXP
    want_p, want_s = torch_to_flax(trainer.model.state_dict())
    # `best` is the trainer's final state
    best, _ = jax_checkpoint.load_checkpoint(str(path), "best")
    _same_tree(jax.device_get(best), {"params": want_p,
                                      "batch_stats": want_s})
    latest, meta = jax_checkpoint.load_checkpoint(str(path), "latest")
    _same_tree(jax.device_get(latest), read_orbax_checkpoint(
        str(path / "latest")))
    host = jax.device_get(world.jax.state)
    target = {"params": host.params, "batch_stats": host.batch_stats,
              "opt_state": host.opt_state}
    got, _ = jax_checkpoint.load_checkpoint(str(path), "latest",
                                            target=target)
    assert isinstance(got["opt_state"], optax.InjectStatefulHyperparamsState)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(target))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(latest)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert meta["epoch"] == 3
    back, summary, lines = handed_back
    assert "resumed from epoch 3 (lr 0.00100)" in lines
    assert summary["epochs"] == 4 and len(summary["loss_results"]) == 4
    assert json.loads((back / EXP / "latest.meta.json").read_text()
                      )["epoch"] == 4


def test_port_run_resumed_from_orbax_writes_orbax_only(world):
    """(6) `latest` and `best` of a run resumed from orbax are orbax
    directories, with no `.pt`; the snapshot file carries its epoch."""
    path = world.root / "port3" / EXP
    assert sorted(os.listdir(path)) == [
        "best", "best.meta.json", "latest", "latest.meta.json",
        "latest.snap.pt"]
    for tag in ("latest", "best"):
        assert checkpoint_format(str(path), tag) == "orbax"
    assert "opt_state" not in read_orbax_checkpoint(str(path / "best"))
    snaps = load_snapshots(str(path), "latest")
    assert snaps["epoch"] == 3
    assert world.port3[0].checkpoint_kind == "orbax"


def test_stale_snapshot_file_is_not_installed(world, handed_back):
    """(7) mdd_tpu's save leaves the port's epoch-3 snapshot file beside
    its epoch-4 `latest`: a port resume does not install it, and says so."""
    back = handed_back[0]
    assert load_snapshots(str(back / EXP), "latest")["epoch"] == 3
    trainer = world.port_trainer()
    lines = []
    epoch = trainer.restore(str(back), EXP, "latest", log=lines.append)
    assert epoch == 4
    assert lines == [
        "latest has no plateau snapshots of its epoch 4 (written before "
        "they were saved, or by mdd_tpu): no halving restores a state "
        "until the dev loss improves again"]
    assert trainer._snapshot is None and trainer._best_acc_state is None
    # the snapshot file of its own epoch is installed
    fresh = world.port_trainer()
    fresh.restore(str(world.root / "port3"), EXP, "latest",
                  log=lines.append)
    assert len(lines) == 1 and fresh._snapshot is not None


# ------------------------------------------------------------- the writer

WRITER_TREES = {
    "dtypes and 0-d": {
        "a": np.arange(-6, 6, dtype=np.float32).reshape(3, 4),
        "i": np.asarray(-7, np.int32),
        "b": np.asarray([True, False, True]),
        "f": np.asarray(2.5, np.float32),
        "big": np.random.default_rng(0).standard_normal(
            (40, 33)).astype(np.float32)},
    "nested lists and empty nodes": {
        "seq": [None, {"count": np.asarray(3, np.int32),
                       "mu": {"x": np.ones((2, 2), np.float32)}},
                [np.zeros(5, np.int32), None], None],
        "empty_dict": {}, "empty_list": [], "none": None,
        "deep": {"a": {"b": {"c": np.asarray([1.5], np.float32)}}}},
}


@pytest.mark.parametrize("name", sorted(WRITER_TREES))
def test_writer_round_trips_through_orbax_and_the_port(tmp_path, name):
    """(5) What write_orbax_checkpoint writes, orbax and the port's reader
    both read back bit for bit."""
    tree = WRITER_TREES[name]
    path = tmp_path / "ckpt"
    write_orbax_checkpoint(str(path), tree)
    _same_tree(read_orbax_checkpoint(str(path)), tree)
    restored = ocp.StandardCheckpointer().restore(str(path))
    _same_tree(jax.device_get(restored), tree)


def test_writer_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(OrbaxFormatError, match=r"x: dtype float64"):
        write_orbax_checkpoint(str(tmp_path / "a"), {"x": np.zeros(2)})
    with pytest.raises(OrbaxFormatError, match="a tree without arrays"):
        write_orbax_checkpoint(str(tmp_path / "b"), {"x": None})
    write_orbax_checkpoint(str(tmp_path / "c"), {"x": np.zeros(2, np.int32)})
    with pytest.raises(FileExistsError):
        write_orbax_checkpoint(str(tmp_path / "c"), {"x": np.zeros(2,
                                                                  np.int32)})


# ------------------------------------------------------------ refusals

def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree


def _bad(opt, what):
    opt = _copy_tree(opt)
    adam = opt["inner_state"][1]
    if what == "missing":
        del adam["mu"]["head"]["kernel"]
    elif what == "unknown":
        adam["nu"]["head"]["extra"] = np.ones(1, np.float32)
    elif what == "shape":
        adam["mu"]["head_bn"]["bias"] = adam["mu"]["head_bn"]["bias"][:-1]
    elif what == "count":
        opt["count"] = np.asarray(5, np.int32)
    elif what == "hyperparams_states":
        opt["hyperparams_states"] = {"learning_rate": 0}
    elif what == "inner_state":
        opt["inner_state"] = [adam]
    elif what == "inner_order":
        opt["inner_state"] = [adam, None, None]
    return opt


REFUSALS = {
    "missing": r"parameters without their mu: \['head/kernel'\]",
    "unknown": r"nu of no parameter: \['head/extra'\]",
    "shape": r"mu of head_bn/bias has shape \(\d+,\) in the port's "
             r"layout, the parameter \(\d+,\)",
    "count": r"inject_hyperparams count 5 != scale_by_adam count 2",
    "hyperparams_states": r"hyperparams_states \{'learning_rate': 0\} is "
                          r"not empty",
    "inner_state": r"inner_state is not \[None, \{count, mu, nu\}, None\]",
    "inner_order": r"inner_state is not \[None, \{count, mu, nu\}, None\]",
}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_malformed_optax_state_raises_naming_it(world, what):
    """(8) No quiet repair: each malformed tree raises ValueError."""
    opt = read_orbax_checkpoint(str(world.epoch1 / EXP / "latest"))[
        "opt_state"]
    with pytest.raises(ValueError, match=REFUSALS[what]):
        optax_adam_to_torch(_bad(opt, what), world.port_trainer().model, WD)


def test_torch_adam_that_optax_cannot_hold_raises(world):
    trainer = world.port_trainer()
    with pytest.raises(ValueError, match="parameters without their moments"):
        torch_adam_to_optax(trainer.optimizer, trainer.model)
    sd = optax_adam_to_torch(read_orbax_checkpoint(str(
        world.epoch1 / EXP / "latest"))["opt_state"], trainer.model, WD)
    sd["param_groups"][0]["amsgrad"] = True
    with pytest.raises(ValueError, match="amsgrad True, optax's Adam"):
        torch_adam_to_optax(sd, trainer.model)


def test_unreadable_or_unmappable_latest_raises(world, tmp_path):
    """No fallback: a `latest/` without opt_state, or with a damaged
    manifest, stops the resume; nothing restarts at epoch 1."""
    no_opt = _copy(world.epoch1, tmp_path / "no_opt")
    shutil.rmtree(no_opt / EXP / "latest")
    shutil.copytree(no_opt / EXP / "best", no_opt / EXP / "latest")
    trainer = world.port_trainer()
    with pytest.raises(ValueError, match="holds no opt_state"):
        load_optimizer_state(str(no_opt / EXP), "latest", trainer.model, WD)
    with pytest.raises(ValueError, match="holds no opt_state"):
        world.port_fit(no_opt, 2)
    damaged = _copy(world.epoch1, tmp_path / "damaged")
    manifest = damaged / EXP / "latest" / "manifest.ocdbt"
    data = bytearray(manifest.read_bytes())
    data[20] ^= 0xFF
    manifest.write_bytes(bytes(data))
    with pytest.raises(OrbaxFormatError, match="CRC32C mismatch"):
        world.port_fit(damaged, 2)
    assert sorted(os.listdir(damaged / EXP)) == [
        "best", "best.meta.json", "latest", "latest.meta.json"]


def test_train_resume_through_the_cli(world, tmp_path, capsys):
    """(9) `python -m mdd_tpu_torch train --resume --device cpu` on the
    YAML's experiment, which holds mdd_tpu's epoch-1 files."""
    conf = Path(world.conf)
    text = conf.read_text().replace(str(world.root / "ckpt"),
                                    str(tmp_path / "ckpt"))
    text = text.replace("num_epoches: 1", "num_epoches: 2")
    (tmp_path / "train2.yaml").write_text(text)
    shutil.copytree(world.epoch1 / EXP, tmp_path / "ckpt" / EXP)
    assert cli.main(["train", "--conf", str(tmp_path / "train2.yaml"),
                     "--resume", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert ("resumed from epoch 1 (lr 0.00100) of mdd_tpu's orbax latest/"
            in out)
    assert "Start training epoch: 2" in out
    assert "Start training epoch: 1," not in out
    path = tmp_path / "ckpt" / EXP
    assert checkpoint_format(str(path), "latest") == "orbax"
    assert not (path / "latest.pt").exists()
    meta = json.loads((path / "latest.meta.json").read_text())
    assert meta["epoch"] == 2 and len(meta["loss_results"]) == 2
    assert FEAT_DIM * 3 == world.model_cfg.input_dim
