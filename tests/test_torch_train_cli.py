"""`python -m mdd_tpu_torch train` on the CPU at a tiny width: one epoch
writes `best` and the resumable `latest` (with the optimizer state),
`--resume` continues at epoch 2, `best` loads into the port's serving
engine, and a config the port cannot train is refused."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mdd_tpu_torch import cli
from mdd_tpu_torch.frontend.cmvn import CmvnStats, write_kaldi_cmvn_text
from mdd_tpu_torch.frontend.wav import write_wav
from mdd_tpu_torch.serve import handle_requests
from test_torch_data import UNITS, write_corpus
from test_torch_lexicon import write_dictionary

ROOT = Path(__file__).resolve().parents[1]


def _yaml(root: Path, epochs: int, **extra) -> str:
    train = write_corpus(root / "data", "train", 10, seed=1, frames=(6, 10))
    dev = write_corpus(root / "data", "dev", 4, seed=2, frames=(6, 10))
    (root / "units").write_text("\n".join(UNITS) + "\n")
    fields = dict(
        exp_name="tiny", checkpoint_dir=str(root / "ckpt"), seed=3,
        vocab_file=str(root / "units"),
        train_scp_path=train[0], train_lab_path=train[1],
        train_trans_path=train[2], valid_scp_path=dev[0],
        valid_lab_path=dev[1], valid_trans_path=dev[2],
        rnn_hidden_size=16, rnn_layers=2, channel="[(1, 4), (4, 4)]",
        use_pallas_lstm=True, device_frontend=True, wire_dtype="bfloat16",
        batch_size=4, num_epoches=epochs, verbose_step=2, num_workers=2,
        time_quantum=8, label_quantum=4)
    fields.update(extra)
    path = root / f"train{epochs}.yaml"
    path.write_text("".join(f"{k}: {json.dumps(v)}\n"
                            for k, v in fields.items()))
    return str(path)


def _train(conf, *flags):
    proc = subprocess.run(
        [sys.executable, "-m", "mdd_tpu_torch", "train", "--conf", conf,
         "--device", "cpu", *flags],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    out = _train(_yaml(root, 1))
    return root, out


def test_one_epoch_writes_best_and_latest(run):
    root, out = run
    assert "Epoch 1 Train done, total_loss:" in out
    assert "Epoch 1 Valid done, total_loss:" in out
    assert "Epoch = 1, step = 2, total_loss =" in out   # verbose_step 2
    ckpt = root / "ckpt" / "tiny"
    for name in ("best.pt", "best.meta.json", "latest.pt",
                 "latest.meta.json", "latest.opt.pt"):
        assert (ckpt / name).exists(), name
    assert not (ckpt / "best.opt.pt").exists()
    opt = torch.load(ckpt / "latest.opt.pt", weights_only=True)
    assert opt["state"] and all("exp_avg" in s for s in opt["state"].values())
    meta = json.loads((ckpt / "latest.meta.json").read_text())
    assert meta["epoch"] == 1 and len(meta["loss_results"]) == 1
    assert np.isfinite(meta["loss_results"][0])
    assert meta["model_config"]["rnn_hidden_size"] == 16


def test_resume_continues_at_epoch_2(run):
    root, _ = run
    out = _train(_yaml(root, 2), "--resume")
    assert "resumed from epoch 1" in out
    assert "Start training epoch: 2" in out
    assert "Start training epoch: 1," not in out
    meta = json.loads((root / "ckpt" / "tiny" / "latest.meta.json"
                       ).read_text())
    assert meta["epoch"] == 2 and len(meta["loss_results"]) == 2


def test_best_loads_into_the_serving_engine(run):
    root, _ = run
    rng = np.random.default_rng(0)
    n = 16000
    sig = 3000 * np.sin(2 * np.pi * 300 * np.arange(n) / 16000.0)
    wav = str(root / "w.wav")
    write_wav(wav, (sig + 500 * rng.standard_normal(n)).astype(np.float32),
              16000)
    cmvn = str(root / "cmvn.txt")
    write_kaldi_cmvn_text(CmvnStats.accumulate(
        [rng.standard_normal((50, 81))]), cmvn)
    # the serving engine requires the lexicon's dictionary files
    dict_dir, _ = write_dictionary(root / "dict")
    args = cli.build_parser().parse_args(
        ["serve", "--conf", _yaml(root, 1), "--cmvn", cmvn,
         "--dict-dir", dict_dir, "--device", "cpu", "--decode-type", "Greedy"])
    engine = cli._build_engine(args)
    (resp,) = handle_requests(engine, [json.dumps(
        {"id": 0, "wav": wav, "word": "w", "canonical": ["sil", "b", "aa"]})])
    assert resp["status"] == "ok", resp


def test_device_cache_is_refused(tmp_path):
    """Without the device front end: the cache holds raw features (the
    port trains on `device_cache` since it ported the cache,
    tests/test_torch_device_cache.py)."""
    conf = _yaml(tmp_path, 1, device_cache=True, device_frontend=False,
                 wire_dtype="")
    with pytest.raises(ValueError, match="requires device_frontend"):
        cli.main(["train", "--conf", conf, "--device", "cpu"])
    assert not (tmp_path / "ckpt").exists()


def test_global_schedule_is_refused(tmp_path):
    """The global schedule is ported (tests/test_torch_global_schedule.py,
    tests/test_torch_distributed_cli.py); what stays refused with it is a
    data_parallel width the run does not have: one process is one rank."""
    conf = _yaml(tmp_path, 1, global_schedule=True, data_parallel=2)
    with pytest.raises(ValueError, match="data_parallel: 2.*torchrun"):
        cli.main(["train", "--conf", conf, "--device", "cpu"])
    assert not (tmp_path / "ckpt").exists()


def test_train_runs_on_the_card_unless_asked():
    args = cli.build_parser().parse_args(["train", "--conf", "x.yaml"])
    assert args.device == "cuda" and not args.resume
