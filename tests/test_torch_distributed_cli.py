"""`python -m mdd_tpu_torch train --distributed` and `evaluate
--distributed` across real processes on the CPU (gloo), on mdd_tpu's CLI
test corpus and YAML (tests/test_distributed_cli.py) plus `drop_out: 0`:
the port draws each rank's dropout masks from its own stream where
mdd_tpu's masks span the global batch (ROADMAP §3 item 7), so only
without dropout can 2 ranks equal 1.

`batch_size` counts rows per rank: 2 ranks x 4 rows log the losses of 1
process x 8 rows, on the row-sharded device cache and on the streaming
loader's global schedule.  The train losses hold mdd_tpu's 1e-4.  The
dev loss is read after the epoch's Adam steps.  Sixteen sound runs
(corpus seeds 0-5, CPU kernels default / AVX2 / AVX-512) read 0 to
2.2e-4 while those steps moved the conv biases by about
lr * sign(rounding), which shifted the eval-mode BatchNorm's input; the
biases' gradient before a train-mode BatchNorm is now exactly 0 (ROADMAP
§3 item 10).  It is held to 5e-4."""

import json
import re
import textwrap
from pathlib import Path

import numpy as np
import pytest

from mdd_tpu_torch import cli
from test_torch_distributed import spawn_ranks, write_corpus

DEV_RTOL = 5e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_cli")
    write_corpus(d)
    return d


@pytest.fixture(scope="module")
def best(corpus):
    """`--checkpoint` of a model trained one epoch in one process."""
    _cli(["train", "--conf", str(_conf(corpus, "eval", 4, cached=False))],
         1)
    return ["--checkpoint", str(corpus / "ckpt" / "eval")]


def _conf(corpus: Path, name: str, batch_size: int, cached: bool,
          force_global: bool = False) -> Path:
    loader = ("device_frontend: true\nwire_dtype: bfloat16\n"
              "device_cache: true\n" if cached else
              f"global_schedule: {str(force_global).lower()}\n")
    conf = corpus / f"{name}.yaml"
    conf.write_text(textwrap.dedent(f"""\
        exp_name: {name}
        checkpoint_dir: '{corpus}/ckpt'
        vocab_file: {corpus}/units
        train_scp_path: {corpus}/f.scp
        train_lab_path: {corpus}/lab
        train_trans_path: {corpus}/trn
        valid_scp_path: {corpus}/f.scp
        valid_lab_path: {corpus}/lab
        valid_trans_path: {corpus}/trn
        test_scp_path: {corpus}/f.scp
        test_lab_path: {corpus}/lab
        test_trans_path: {corpus}/trn
        rnn_hidden_size: 16
        rnn_layers: 1
        batch_size: {batch_size}
        num_epoches: 1
        verbose_step: 1
        max_adjust_times: 1
        num_workers: 0
        shuffle_train: false
        drop_out: 0.0
    """) + loader)
    return conf


def _cli(args, n: int):
    """`python -m mdd_tpu_torch <args> --device cpu`, one process (n = 1)
    or n ranks with --distributed."""
    argv = ["-m", "mdd_tpu_torch"] + list(args) + ["--device", "cpu"]
    if n > 1:
        argv.append("--distributed")
    return spawn_ranks(argv, n, distributed=n > 1)


def _losses(text: str):
    """(per-step running train losses, epoch train loss, dev loss)."""
    steps = [float(v) for v in
             re.findall(r"step = \d+, total_loss = ([\d.]+)", text)]
    train = float(re.search(r"Train done, total_loss: ([\d.]+)",
                            text).group(1))
    dev = float(re.search(r"Valid done, total_loss: ([\d.]+)",
                          text).group(1))
    return steps, train, dev


@pytest.mark.parametrize("cached", [True, False],
                         ids=["device-cache", "streaming-global-schedule"])
def test_cli_train_distributed_matches_single(corpus, cached):
    name = "cached" if cached else "stream"
    single = _cli(["train", "--conf", str(_conf(
        corpus, f"{name}_single", 8, cached, force_global=True))], 1)[0]
    outs = _cli(["train", "--conf", str(_conf(
        corpus, f"{name}_dist", 4, cached))], 2)
    for r, o in enumerate(outs):
        assert f"distributed: process {r}/2, backend gloo, device cpu" in o
    got, want = _losses(outs[0]), _losses(single)
    assert _losses(outs[1]) == got        # every rank logs the same
    assert len(got[0]) == len(want[0]) == 2   # 12 utterances, 8 a step
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=DEV_RTOL)
    # rank 0 wrote the checkpoints
    assert (corpus / "ckpt" / f"{name}_dist" / "best.pt").exists()


def _tallies(text: str):
    return re.findall(r"(total_error: \d+|total_phoneme: \d+|TA :  \d+"
                      r"|FR :  \d+|FA :  \d+|TR :  \d+|TR correct :  \d+"
                      r"|TR wrong :   \d+)", text)


@pytest.mark.parametrize("batch_size", [1, 4])
def test_cli_evaluate_distributed_matches_single(corpus, best, batch_size,
                                                 tmp_path):
    """Each rank decodes its 6 of the 12 utterances; the summed report
    equals the one-process one at batch 1 (each utterance padded alike)
    and at batch 4 on this corpus, whose rows group other utterances
    (the outputs depend on the padding, ROADMAP §3 item 2); the dumps go
    to rank0/ and rank1/ and hold every utterance once."""
    conf = _conf(corpus, f"eval{batch_size}", batch_size, cached=False)
    single = _cli(["evaluate", "--conf", str(conf)] + best, 1)[0]
    dump = tmp_path / "dump"
    outs = _cli(["evaluate", "--conf", str(conf), "--dump-dir", str(dump)]
                + best, 2)
    want = _tallies(single)
    assert len(want) == 16, single[-2000:]
    for o in outs:
        assert _tallies(o) == want
    utts = sorted(line.split()[0] for r in (0, 1) for line in
                  (dump / f"rank{r}" / "decode_seq.log").read_text(
                  ).splitlines())
    assert utts == sorted(f"u{i}" for i in range(12))


def test_cli_evaluate_distributed_wraparound(corpus, best):
    """5 ranks over 12 utterances: 3 a rank, 3 wrap-around duplicates
    decoded but not scored; the report is the one-process one."""
    conf = _conf(corpus, "eval_wrap", 1, cached=False)
    want = _tallies(_cli(["evaluate", "--conf", str(conf)] + best, 1)[0])
    outs = _cli(["evaluate", "--conf", str(conf)] + best, 5)
    assert all(_tallies(o) == want for o in outs)


@pytest.mark.parametrize("cmd", ["train", "evaluate"])
def test_incomplete_environment_raises(corpus, cmd, monkeypatch):
    conf = _conf(corpus, "env", 4, cached=False)
    for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="LOCAL_RANK, MASTER_ADDR, "
                                         "MASTER_PORT are missing"):
        cli.main([cmd, "--conf", str(conf), "--device", "cpu",
                  "--distributed"])


def test_cached_evaluate_with_several_ranks_raises(corpus):
    """mdd_tpu warns and evaluates through the streaming loader; the port
    refuses (ROADMAP §3 item 7)."""
    conf = _conf(corpus, "eval_cached", 4, cached=True)
    argv = ["-m", "mdd_tpu_torch", "evaluate", "--conf", str(conf),
            "--device", "cpu", "--cached", "--distributed"]
    with pytest.raises(AssertionError, match="streaming loader"):
        spawn_ranks(argv, 2)


def test_profile_dir_writes_a_trace_a_rank(corpus, tmp_path):
    conf = _conf(corpus, "profiled", 4, cached=False)
    outs = _cli(["train", "--conf", str(conf), "--profile-dir",
                 str(tmp_path)], 2)
    for r, o in enumerate(outs):
        path = tmp_path / f"trace_rank{r}.json"
        assert f"profile -> {path}" in o
        assert json.loads(path.read_text())["traceEvents"]
