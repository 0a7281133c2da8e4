"""One command over every local card: `train`, `evaluate` and `benchmark`
read `data_parallel` as mdd_tpu's one-process mesh does
(parallel/launch.py), on the CPU, where `data_parallel: N` is N gloo
ranks (the counterpart of the conftest's virtual CPU devices).

  1. `train --device cpu` at `data_parallel: 2` (two ranks from the
     launcher) against mdd_tpu's `train` at `data_parallel: 2`
     (`Trainer(n_devices=2)` on two of the virtual devices), from the same
     seeded weights (mdd_tpu's orbax `latest` at epoch 0, which the port
     reads through convert.py), B=5, so the width divides no batch: every
     logged train loss within 1e-4, the dev loss within DEV_RTOL
     (test_torch_distributed_cli.py says why); the run's orbax `latest`
     and `best` written once;
  2. `evaluate` over 2 ranks, streaming and `--cached`: one set of dumps,
     equal byte for byte to the one-process run's, no `rank*/`
     directory, and the tallies of mdd_tpu's evaluate_model over a
     2-device mesh;
  3. the width rule (make_mesh's), and more cards than the host has
     refused before any rank starts (torchrun's rule:
     test_torch_train_cli.py::test_global_schedule_is_refused);
  4. a rank that fails ends the command with its code at once; SIGINT,
     SIGTERM and SIGKILL of the launcher end every rank;
  5. the loaders' rank shares put together are one process's batches;
     a rank whose share is all padding adds exact zeros to BatchNorm's
     sums;
  6. `benchmark` over 2 ranks: rank 0's one line, its rates per card;
  7. processes that build a kernel at once (N ranks at their first
     launch) leave one whole library;
  8. `serve` and `infer` stay one process.

Every rank is a real process; every wait has a timeout."""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mdd_tpu.cli import _model_config_from_meta
from mdd_tpu.cli import main as jax_main
from mdd_tpu.data.dataset import BucketedLoader as JaxLoader
from mdd_tpu.data.dataset import SpeechDataset as JaxDataset
from mdd_tpu.data.device_cache import CachedLoader as JaxCachedLoader
from mdd_tpu.data.device_cache import DeviceFeatureCache as JaxCache
from mdd_tpu.data.vocab import Vocab as JaxVocab
from mdd_tpu.evals.evaluate import EvalSession as JaxEvalSession
from mdd_tpu.evals.evaluate import evaluate_model as jax_evaluate_model
from mdd_tpu.parallel.mesh import make_mesh
from mdd_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from mdd_tpu.train.loop import Trainer as JaxTrainer
from mdd_tpu.utils.config import load_config as jax_load_config
from mdd_tpu_torch import cli
from mdd_tpu_torch.data.dataset import BucketedLoader, SpeechDataset
from mdd_tpu_torch.data.device_cache import CachedLoader, DeviceFeatureCache
from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.models import ctc_model
from mdd_tpu_torch.ops import build
from mdd_tpu_torch.parallel import launch, mesh
from test_torch_distributed import write_corpus
from test_torch_distributed_cli import DEV_RTOL, _losses, _tallies

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 240
EXP = "exp"


def _conf(d: Path, name: str, batch_size: int, data_parallel: int,
          cached: bool = False, ckpt: str = "ckpt") -> str:
    """mdd_tpu's CLI test YAML (tests/test_distributed_cli.py) at a tiny
    width, dropout 0 (the port draws a rank's masks from its own stream,
    ROADMAP §3 item 4), shuffled batches through the threaded loader."""
    extra = ("device_frontend: true\nwire_dtype: bfloat16\n"
             if cached else "")
    path = d / f"{name}.yaml"
    path.write_text(textwrap.dedent(f"""\
        exp_name: {EXP}
        checkpoint_dir: '{d / ckpt}'
        seed: 7
        vocab_file: {d}/units
        train_scp_path: {d}/f.scp
        train_lab_path: {d}/lab
        train_trans_path: {d}/trn
        valid_scp_path: {d}/f.scp
        valid_lab_path: {d}/lab
        valid_trans_path: {d}/trn
        test_scp_path: {d}/f.scp
        test_lab_path: {d}/lab
        test_trans_path: {d}/trn
        rnn_hidden_size: 16
        rnn_layers: 1
        batch_size: {batch_size}
        num_epoches: 1
        verbose_step: 1
        max_adjust_times: 1
        num_workers: 2
        drop_out: 0.0
        beam_width: 4
        data_parallel: {data_parallel}
    """) + extra)
    return str(path)


@contextlib.contextmanager
def _one_thread():
    """Each rank one CPU thread: the ranks share the host's cores."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _port(argv) -> str:
    """`python -m mdd_tpu_torch <argv>` through cli.main in this process
    (the launcher starts the ranks); -> the command's stdout."""
    out = io.StringIO()
    with _one_thread(), contextlib.redirect_stdout(out):
        assert cli.main(list(argv)) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("local_cards")
    write_corpus(d)
    return d


@pytest.fixture(scope="module")
def runs(corpus):
    """mdd_tpu's `train` at data_parallel 2 and the port's from the same
    weights: mdd_tpu's seeded Trainer (the one its CLI builds) saves its
    state as `latest` at epoch 0, which the port's `train --resume`
    takes; -> (dir, mdd_tpu's output, the port's output)."""
    d = corpus
    conf = _conf(d, "train", 5, 2)
    cfg = jax_load_config(conf)
    vocab = JaxVocab.from_units_file(cfg.vocab_file)
    seeded = JaxTrainer(
        cfg.model_config(vocab.n_words), init_lr=cfg.init_lr,
        weight_decay=cfg.weight_decay, lr_decay=cfg.lr_decay,
        end_adjust_acc=cfg.end_adjust_acc,
        plateau_patience=cfg.plateau_patience,
        max_adjust_times=cfg.max_adjust_times, seed=cfg.seed,
        n_devices=cfg.data_parallel)
    seeded.save(str(d / "port_ckpt"), EXP, "latest", 0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_main(["train", "--conf", conf]) == 0
    port = _port(["train", "--conf", _conf(d, "port", 5, 2,
                                           ckpt="port_ckpt"),
                  "--device", "cpu", "--resume"])
    return d, out.getvalue(), port


def test_train_matches_mdd_tpu_mesh(runs):
    d, theirs, ours = runs
    assert "resumed from epoch 0 " in ours and "orbax" in ours
    assert "distributed: process 0/2, backend gloo, device cpu" in ours
    got, want = _losses(ours), _losses(theirs)
    assert len(got[0]) == len(want[0]) == 3   # 12 utterances, 5 a step
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=DEV_RTOL)
    # the run keeps mdd_tpu's format, written by rank 0 alone
    ckpt = d / "port_ckpt" / EXP
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "best", "best.meta.json", "latest", "latest.meta.json",
        "latest.snap.pt"]
    assert json.loads((ckpt / "latest.meta.json").read_text())["epoch"] == 1


@pytest.mark.parametrize("cached,batch_size", [(False, 5), (True, 4)],
                         ids=["streaming", "cached"])
def test_evaluate_writes_one_set_of_dumps(runs, cached, batch_size):
    """mdd_tpu's `best` after its epoch, decoded by the port in one
    process and over 2 ranks, and by mdd_tpu's evaluate_model over a
    2-device mesh.  The cached batch divides the mesh, which mdd_tpu's
    cached path needs; the streaming one does not."""
    d, _, _ = runs
    flags = ["--device", "cpu", "--checkpoint", str(d / "ckpt" / EXP)]
    flags += ["--cached"] if cached else []
    name = "cached" if cached else "stream"
    one = _port(["evaluate", "--conf", _conf(d, f"{name}1", batch_size, 1,
                                             cached),
                 "--dump-dir", str(d / f"{name}_one")] + flags)
    two = _port(["evaluate", "--conf", _conf(d, f"{name}2", batch_size, 2,
                                             cached),
                 "--dump-dir", str(d / f"{name}_two")] + flags)
    assert "distributed: process 0/2" in two
    assert sorted(p.name for p in (d / f"{name}_two").iterdir()) == [
        "decode_seq.log", "human_seq.log", "transcribe.log"]
    for f in ("decode_seq.log", "human_seq.log", "transcribe.log"):
        assert ((d / f"{name}_two" / f).read_bytes()
                == (d / f"{name}_one" / f).read_bytes()), f
    assert len((d / f"{name}_two" / "decode_seq.log").read_text()
               .splitlines()) == 12

    cfg = jax_load_config(_conf(d, f"{name}2", batch_size, 2, cached))
    vocab = JaxVocab.from_units_file(cfg.vocab_file)
    state, meta = jax_load_checkpoint(str(d / "ckpt" / EXP), "best")
    session = JaxEvalSession(
        _model_config_from_meta(meta),
        {"params": state["params"], "batch_stats": state["batch_stats"]},
        vocab, decode_type=cfg.decode_type, beam_width=cfg.beam_width,
        mesh=make_mesh(2), device_frontend=cfg.device_frontend)
    ds = JaxDataset(vocab, cfg.test_scp_path, cfg.test_lab_path,
                    cfg.test_trans_path, device_frontend=cfg.device_frontend)
    if cached:
        cache = JaxCache(ds, mesh=session.mesh, time_quantum=cfg.time_quantum,
                         wire_dtype=cfg.wire_dtype)
        session.attach_cache(cache)
        loader = JaxCachedLoader(cache, batch_size,
                                 label_quantum=cfg.label_quantum)
    else:
        loader = JaxLoader(ds, batch_size, time_quantum=cfg.time_quantum,
                           label_quantum=cfg.label_quantum)
    lines = []
    jax_evaluate_model(session, loader,
                       log=lambda *a: lines.append(" ".join(map(str, a))))
    want = _tallies("\n".join(lines))
    assert len(want) == 16
    assert _tallies(two) == _tallies(one) == want


# ---------------------------------------------------------- 3. the width
@pytest.mark.parametrize("dp,device,cards,every,want", [
    (0, "cuda", 4, False, 4),       # make_mesh(0): every device
    (2, "cuda", 4, False, 2),       # the first two
    (1, "cuda", 4, False, 1),
    (2, "cuda", 4, True, 4),        # evaluate: make_local_mesh()
    (0, "cuda:3", 4, True, 1),      # a named card is one card
    (0, "cuda", 0, False, 1),       # no card: the command says so
    (0, "cpu", 4, False, 1),
    (3, "cpu", 0, True, 3),         # N CPU ranks
])
def test_width_is_make_mesh_s(monkeypatch, dp, device, cards, every, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert launch.local_width(dp, device, every_card=every) == want


@pytest.mark.parametrize("dp,cards", [(3, 2), (1, 0)])
def test_more_cards_than_the_host_has_raise_before_any_rank(
        corpus, monkeypatch, dp, cards):
    d = corpus
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(launch, "launch_local", pytest.fail)
    monkeypatch.setattr(cli, "cmd_train", pytest.fail)
    with pytest.raises(ValueError,
                       match=f"requested {dp} devices, have {cards}"):
        cli.main(["train", "--conf", _conf(d, "wide", 5, dp)])


# ---------------------------------------------------- 4. failing ranks
RANK = textwrap.dedent('''\
    import os, signal, sys, time
    from mdd_tpu_torch.parallel import launch
    launch.follow_launcher()
    r = int(os.environ["RANK"])
    out = sys.argv[1]
    def stopped(signum, frame):
        open(os.path.join(out, f"sig{r}"), "w").write(str(signum))
        sys.exit(9)
    signal.signal(signal.SIGINT, stopped)
    signal.signal(signal.SIGTERM, stopped)
    open(os.path.join(out, f"pid{r}"), "w").write(str(os.getpid()))
    if r == int(sys.argv[2]):
        # fail once the other rank stands ready for a signal
        while not os.path.exists(os.path.join(out, f"pid{1 - r}")):
            time.sleep(0.05)
        sys.exit(3)
    time.sleep(600)
''')


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.mark.parametrize("failing", [0, 1])
def test_a_failing_rank_ends_the_command(tmp_path, monkeypatch, failing):
    """The rank exits 3 while the other would sleep 10 minutes: the
    command returns 3 at once and the other rank is gone."""
    monkeypatch.setattr(launch, "RANK_ENTRY", (sys.executable, "-c", RANK))
    t0 = time.monotonic()
    rc = launch.launch_local([str(tmp_path), str(failing)], 2, "cpu")
    assert rc == 3
    assert time.monotonic() - t0 < 60
    other = 1 - failing
    assert not _alive(int((tmp_path / f"pid{other}").read_text()))
    assert (tmp_path / f"sig{other}").read_text() == str(int(signal.SIGTERM))


LAUNCHER = textwrap.dedent('''\
    import sys
    from mdd_tpu_torch.parallel import launch
    launch.RANK_ENTRY = (sys.executable, "-c", sys.argv[2])
    sys.exit(launch.launch_local([sys.argv[1], "-1"], 2, "cpu"))
''')


@pytest.mark.parametrize("sig", [signal.SIGINT, signal.SIGTERM,
                                 signal.SIGKILL],
                         ids=["SIGINT", "SIGTERM", "SIGKILL"])
def test_a_stopped_launcher_stops_every_rank(tmp_path, sig):
    """SIGINT (Ctrl-C) to the launcher alone reaches both ranks and it
    exits non-zero; where SIGTERM or SIGKILL ends the launcher, its ranks
    die with it."""
    proc = subprocess.Popen([sys.executable, "-c", LAUNCHER, str(tmp_path),
                             RANK], cwd=REPO,
                            env=dict(os.environ, PYTHONPATH=str(REPO)))
    deadline = time.monotonic() + TIMEOUT
    # a rank creates its pid file, then writes it: wait for the number
    while not all((tmp_path / f"pid{r}").exists()
                  and (tmp_path / f"pid{r}").read_text() for r in (0, 1)):
        assert time.monotonic() < deadline and proc.poll() is None
        time.sleep(0.05)
    pids = [int((tmp_path / f"pid{r}").read_text()) for r in (0, 1)]
    proc.send_signal(sig)
    try:
        assert proc.wait(timeout=60) != 0
    finally:
        if proc.poll() is None:
            proc.kill()
    while any(map(_alive, pids)):
        assert time.monotonic() < deadline
        time.sleep(0.05)
    if sig == signal.SIGINT:
        for r in (0, 1):
            assert (tmp_path / f"sig{r}").read_text() == str(int(sig))


# --------------------------------------------------- 5. shares and sums
def _dataset(d: Path, device_frontend: bool):
    return SpeechDataset(Vocab.from_units_file(str(d / "units")),
                         str(d / "f.scp"), str(d / "lab"), str(d / "trn"),
                         train=True, device_frontend=device_frontend)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("kind", ["streaming", "cached"])
def test_rank_shares_make_one_process_s_batches(corpus, kind, n):
    """B=5 over n ranks: each rank ceil(5/n) slots of every global batch,
    padded to the global batch's widths; the ranks' real rows, put
    together, are one process's batch, rows and widths, for two shuffled
    epochs."""
    d = corpus
    ds = _dataset(d, device_frontend=kind == "cached")
    if kind == "cached":
        cache = DeviceFeatureCache(ds, "cpu", time_quantum=8,
                                   shard_rows=False)
        make = lambda r, p, split: CachedLoader(
            cache, 5, shuffle=True, seed=2, process_index=r,
            process_count=p, split_batch=split)
    else:
        make = lambda r, p, split: BucketedLoader(
            ds, 5, shuffle=True, seed=2, time_quantum=8,
            process_index=r, process_count=p, split_batch=split)
    one = make(0, 1, False)
    ranks = [make(r, n, True) for r in range(n)]
    assert all(ld.batch_size == -(-5 // n) for ld in ranks)
    assert all(len(ld) == len(one) for ld in ranks)
    for _ in range(2):
        for want, shares in zip(one, zip(*ranks)):
            rows = lambda b: b.valid if kind == "cached" else b.score_mask
            keep = np.concatenate([rows(b) for b in shares])
            assert keep.sum() == np.asarray(rows(want)).sum()
            got_utts = [u for b in shares for u, k in
                        zip(b.utt_ids, rows(b)) if k]
            assert got_utts == [u for u, k in zip(want.utt_ids, rows(want))
                                if k]
            for b in shares:
                assert b.size == -(-5 // n)
                if kind == "cached":
                    assert b.bucket == want.bucket
                    assert b.targets.shape[1] == want.targets.shape[1]
                    assert list(b.global_idx[:want.size]) == list(want.idx)
                else:
                    assert b.inputs.shape[1:] == want.inputs.shape[1:]
                    assert b.trans.shape[1] == want.trans.shape[1]


def test_a_share_of_padding_adds_zeros_to_the_statistics(monkeypatch):
    """A rank whose rows are all padding (B < N, or a short last batch)
    contributes exact zeros to BatchNorm's sums and count, even where its
    padding rows hold non-finite values, and reads the other ranks'
    statistics: never 0 / 0."""
    other = torch.tensor([[3.0, -1.0], [9.0, 5.0], [2.0, 2.0]])
    sent = []

    def reduce(sums):
        sent.append(sums.detach().clone())
        return sums + other
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    monkeypatch.setattr(mesh, "all_reduce_sum", reduce)
    x = torch.full((3, 4, 2), float("nan"))
    x[1] = float("inf")
    mean, var = ctc_model.batch_stats(x, -1, torch.zeros(3, dtype=torch.bool))
    assert torch.equal(sent[0], torch.zeros_like(sent[0]))
    torch.testing.assert_close(mean, other[0] / other[2])
    torch.testing.assert_close(var, torch.clamp(
        other[1] / other[2] - (other[0] / other[2]) ** 2, min=0.0))
    assert torch.isfinite(mean).all() and torch.isfinite(var).all()


# ----------------------------------------------------- 6. the benchmark
BENCH_RANK = textwrap.dedent('''\
    import functools, sys
    from mdd_tpu_torch import bench, cli
    from mdd_tpu_torch.models.ctc_model import ModelConfig
    bench.flagship_config = lambda device: ModelConfig(
        rnn_hidden_size=16, rnn_layers=1, conv_channels=(4, 4),
        text_embed_size=8, num_class=43)
    sizes = {
        "bench_train": dict(batch=1, frames=32, label_len=6, warmup=1,
                            steps=2),
        "bench_decode": dict(batch=2, frames=10, rounds=1),
        "bench_frontend": dict(batch=2, seconds=0.5, rounds=1, n_utts=2,
                               utt_seconds=0.5),
        "bench_eval": dict(n_utts=6, batch=4, cached_batch=4, passes=1,
                           workers=1, checkpoint_dir=sys.argv[1]),
        "bench_epoch": dict(n_utts=6, batch=4, epochs=1, workers=1),
    }
    for name, kw in sizes.items():
        setattr(bench, name, functools.partial(getattr(bench, name), **kw))
    sys.exit(cli.main(["benchmark", "--device", "cpu"]))
''')


def test_benchmark_over_two_ranks(tmp_path):
    """Rank 0 prints the one line, with n_cards 2; the train and epoch
    rates are per card (the line's own times give them back at 2 cards),
    evaluation covers every utterance once.  The train batch of one row
    leaves rank 1 a share of padding alone: its loss share is 0."""
    out = io.StringIO()
    with _one_thread(), contextlib.redirect_stdout(out), \
            pytest.MonkeyPatch.context() as mp:
        mp.delenv("MDD_REFERENCE_DATA", raising=False)
        mp.setattr(launch, "RANK_ENTRY", (sys.executable, "-c", BENCH_RANK))
        assert launch.launch_local([str(tmp_path / "no_checkpoint")], 2,
                                   "cpu") == 0
    lines = out.getvalue().splitlines()
    assert len(lines) == 1, lines
    extra = json.loads(lines[0])["extra"]
    assert extra["n_cards"] == 2 and extra["card"] == "cpu"
    value = json.loads(lines[0])["value"]
    per_card = 1 * 32 * 0.02 / (extra["ms_per_step"] / 1e3) / 2
    assert value == pytest.approx(per_card, rel=0.02)
    assert extra["epoch_audio_s_per_s_cached"] == pytest.approx(
        extra["epoch_audio_s"] / extra["epoch_s_cached"] / 2, rel=0.02)
    assert extra["eval_n_utts"] == 6 and extra["mfu"] is None
    assert extra["cache_mb_per_device"] <= extra["cache_mb"] / 2 + 0.1
    assert extra["decode_utts_per_s"] > 0


# ----------------------------------------------------- 7. the kernels
NVCC = textwrap.dedent('''\
    #!{python}
    import sys, time
    args = sys.argv[1:]
    out, src = args[args.index("-o") + 1], args[-1]
    with open("{log}", "a") as f:
        f.write(src + "\\n")
    with open(out, "w") as f:
        f.write("half of " + src)
        f.flush()
        time.sleep(0.3)
        f.write(" and the rest")
''')


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """An nvcc that logs each source it builds and writes its output in
    two parts; the build directory in tmp_path; -> the log."""
    (tmp_path / "cuda" / "bin").mkdir(parents=True)
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    log = tmp_path / "nvcc.log"
    nvcc.write_text(NVCC.format(python=sys.executable, log=log))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return log


def test_processes_building_at_once_leave_one_whole_library(stub_nvcc,
                                                            tmp_path):
    code = ("import sys; from mdd_tpu_torch.ops import build; "
            f"build.BUILD_DIR = __import__('pathlib').Path({str(tmp_path)!r})"
            " / '_build'; build.build('lstm_fwd.cu')")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=str(REPO)))
             for _ in range(4)]
    assert [p.wait(timeout=TIMEOUT) for p in procs] == [0] * 4
    out = build.library_path("lstm_fwd.cu")
    assert out.read_text().endswith("lstm_fwd.cu and the rest")
    assert sorted(p.name for p in out.parent.iterdir()) == sorted(
        [out.name, out.with_suffix(".log").name])


# --------------------------------------------------- 8. serve and infer
@pytest.mark.parametrize("command", ["serve", "infer"])
def test_serve_and_infer_stay_one_process(corpus, monkeypatch, command):
    """On a host of 4 cards, data_parallel 0 (every card for train): a
    request is answered by one process on one card."""
    d = corpus
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(launch, "launch_local", pytest.fail)
    seen = []
    monkeypatch.setattr(cli, f"cmd_{command}",
                        lambda args: seen.append(
                            (args.device, mesh.process_count())) or 0)
    argv = [command, "--conf", _conf(d, "serve", 4, 0), "--cmvn", "c"]
    if command == "infer":
        argv += ["--wav-transcript-path", str(d)]
    assert cli.main(argv) == 0
    assert seen == [("cuda", 1)]
    assert command not in cli.LOCAL_MESH_COMMANDS
