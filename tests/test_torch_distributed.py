"""The port's data-parallel path on the CPU: real processes joined by
torch.distributed (gloo), each launched with torchrun's environment.

  1. `mdd_tpu_torch.tools.distributed_smoke` over 2 ranks equals its
     1-process run (train losses, dev loss and acc, the summed MDD report,
     the loss of an epoch on the row-sharded device cache), as
     tests/test_distributed_real.py holds mdd_tpu's tool;
  2. one step's summed gradients, BN running statistics and updated
     parameters over 2 ranks equal 1 rank's on the same global batch, with
     masked rows spread unevenly over the ranks;
  3. 2 ranks' train losses equal mdd_tpu's one-process Trainer's on the
     same global batches and weights (1e-5 on the first step, 1e-4 after
     three);
  4. the row-sharded gather equals the replicated one bit for bit;
  5. two ranks with one seed draw different dropout masks (plain and
     fused) and identical weight noise;
  6. the backend rule (nccl with a card a local rank, else gloo), on
     init_distributed with the group's constructor stubbed.

Every subprocess has a timeout, every rank its own free port, and the
group's init a timeout of its own (parallel.mesh.INIT_TIMEOUT_S)."""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdd_tpu.data.dataset import Batch as JaxBatch
from mdd_tpu.models.ctc_model import ModelConfig as JaxConfig
from mdd_tpu.parallel.mesh import replicated
from mdd_tpu.train.loop import Trainer as JaxTrainer
from mdd_tpu_torch.convert import flax_to_torch, random_flax_variables
from mdd_tpu_torch.models.ctc_model import ModelConfig

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(argv, n: int, cwd=REPO, distributed: bool = True):
    """Run `argv` as `n` ranks (torchrun's variables, one free port), or
    as one plain process with `distributed=False`; -> each one's output.
    Fails on a non-zero exit or a timeout of any rank."""
    port = free_port()
    procs = []
    for rank in range(n):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                            "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
        # one thread a rank: gloo's ranks on one host share its cores
        env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
        if distributed:
            env.update(RANK=str(rank), WORLD_SIZE=str(n),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable] + [a.replace("{rank}", str(rank)) for a in argv],
            cwd=cwd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return outs


# ------------------------------------------------------------ 1. the tool
def _smoke(n: int, tmp_path: Path):
    spawn_ranks(["-m", "mdd_tpu_torch.tools.distributed_smoke", "--device",
                 "cpu", "--out", str(tmp_path / f"p{n}_{{rank}}.json")],
                n, distributed=n > 1)
    return [json.loads((tmp_path / f"p{n}_{r}.json").read_text())
            for r in range(n)]


def test_distributed_smoke_two_ranks_match_one(tmp_path):
    single = _smoke(1, tmp_path)[0]
    two = _smoke(2, tmp_path)
    assert [r["num_processes"] for r in two] == [2, 2]
    # every rank logs the same numbers (the reductions are alike on all)
    assert two[0]["train_losses"] == two[1]["train_losses"]
    assert two[0]["dev_loss"] == two[1]["dev_loss"]
    assert two[0]["dev_acc"] == two[1]["dev_acc"]
    # and they are the one-process run's
    np.testing.assert_allclose(two[0]["train_losses"],
                               single["train_losses"], rtol=1e-5)
    np.testing.assert_allclose(two[0]["dev_loss"], single["dev_loss"],
                               rtol=1e-5)
    assert two[0]["dev_acc"] == pytest.approx(single["dev_acc"], abs=1e-9)
    assert two[0]["report_vector"] == single["report_vector"]
    assert two[1]["report_vector"] == single["report_vector"]
    for r in two:
        np.testing.assert_allclose(r["cached_loss"], single["cached_loss"],
                                   rtol=1e-5)


# ------------------------------------------------- 2, 4, 5: one worker
WORKER = textwrap.dedent('''\
    import json, os, sys
    import numpy as np, torch
    from mdd_tpu_torch.parallel import mesh
    if os.environ.get("WORLD_SIZE"):
        mesh.init_distributed("cpu")
    from mdd_tpu_torch.data.dataset import Batch, SpeechDataset
    from mdd_tpu_torch.data.device_cache import CachedLoader, DeviceFeatureCache
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.models.ctc_model import ModelConfig, dropout
    from mdd_tpu_torch.train.loop import Trainer

    out_dir = sys.argv[1]
    r, n = mesh.process_index(), mesh.process_count()
    out = {}

    # 2. one step over the global batch of 8 rows, rows 5-7 masked out:
    # rank 0 keeps 4 rows, rank 1 one (the count differs by rank)
    cfg = ModelConfig(input_dim=24, num_class=12, rnn_hidden_size=16,
                      rnn_layers=2, conv_channels=(4, 4), text_embed_size=8,
                      dropout=0.0)
    tr = Trainer(cfg, seed=11, device="cpu")
    rng = np.random.default_rng(0)
    B, t, l = 8, 16, 4
    x = rng.standard_normal((B, t, 24)).astype(np.float32)
    y = rng.integers(2, 12, (B, l)).astype(np.int32)
    keep = np.arange(B) < 5
    x[~keep] *= 40.0       # wild values that must not reach the statistics
    b = B // n
    sl = slice(r * b, (r + 1) * b)
    batch = Batch(x[sl], np.ones(b, np.float32), y[sl], np.full(b, l, np.int32),
                  y[sl].copy(), np.full(b, l, np.int32), ["u"] * b)
    tr.optimizer.zero_grad()
    loss, _, _ = tr._loss_and_out(tr.batch_arrays(batch, keep[sl]), True)
    loss.backward()
    tr.all_reduce_gradients()
    out["loss"] = float(mesh.all_reduce_metrics(np.array([loss.item()]))[0])
    out["grad"] = {k: p.grad.tolist() for k, p in tr.model.named_parameters()}
    out["stats"] = {k: v.tolist() for k, v in tr.model.named_buffers()}
    tr.optimizer.step()
    out["param"] = {k: p.detach().tolist()
                    for k, p in tr.model.named_parameters()}

    # 4. the row-sharded gather against the replicated one, both wires
    vocab = Vocab(["sil", "aa", "b", "k"])
    ds = SpeechDataset(vocab, *(os.path.join(out_dir, f) for f in
                       ("f.scp", "lab", "trn")), train=True,
                       device_frontend=True)
    out["gather"] = {}
    for wire in ("float32", "bfloat16"):
        sharded = DeviceFeatureCache(ds, "cpu", time_quantum=8,
                                     wire_dtype=wire, process_index=r,
                                     process_count=n)
        full = DeviceFeatureCache(ds, "cpu", time_quantum=8, wire_dtype=wire,
                                  shard_rows=False)
        loader = CachedLoader(sharded, 8 // n, shuffle=True, seed=4,
                              process_index=r, process_count=n)
        rows = []
        for cb in loader:
            a, fa = sharded.gather(cb)
            want = full.buckets[cb.bucket].index_select(
                0, torch.as_tensor(cb.idx).long())
            assert a.dtype == want.dtype and a.shape == want.shape
            assert a.view(torch.int16 if wire == "bfloat16"
                          else torch.int32).equal(
                want.view(torch.int16 if wire == "bfloat16"
                          else torch.int32)), "sharded gather differs"
            rows.append(a.float().tolist())
        out["gather"][wire] = rows
        out["bytes_per_device"] = sharded.bytes_per_device
        out["bytes"] = sharded.bytes

    # 5. dropout masks (plain, fused) and weight noise, one seed
    tr5 = Trainer(ModelConfig(input_dim=24, num_class=12, rnn_hidden_size=8,
                              rnn_layers=1, conv_channels=(4, 4),
                              text_embed_size=8, dropout=0.5),
                  seed=7, device="cpu")
    ones = torch.ones(4, 64)
    out["mask"] = dropout(ones, 0.5, True, tr5.generator).tolist()
    out["fused_mask"] = dropout(ones, 0.5, True, tr5.generator,
                                fused=True).tolist()
    before = {k: p.detach().clone() for k, p in tr5.model.named_parameters()}
    tr5.add_weight_noise(0.1)
    out["noise"] = {k: (p.detach() - before[k]).tolist()
                    for k, p in tr5.model.named_parameters()}
    with open(os.path.join(out_dir, f"w{n}_{r}.json"), "w") as f:
        json.dump(out, f)
    mesh.shutdown()
''')


def write_corpus(d: Path, n: int = 12, seed: int = 0) -> None:
    """mdd_tpu's CLI test corpus (tests/test_distributed_cli.py): `n`
    utterances of 24-63 frames x 81 dims, labels "aa b k", with one
    entry -0.0 to hold the gather's bits to."""
    from mdd_tpu_torch.frontend import kaldi_io

    rng = np.random.default_rng(seed)
    with kaldi_io.ArkScpWriter(str(d / "f.ark"), str(d / "f.scp")) as w, \
            open(d / "lab", "w") as lab, open(d / "trn", "w") as trn:
        for i in range(n):
            t = int(rng.integers(24, 64))
            feat = rng.standard_normal((t, 81)).astype(np.float32)
            feat[0, 0] = -0.0
            w.write(f"u{i}", feat)
            lab.write(f"u{i} aa b k\n")
            trn.write(f"u{i} aa b k\n")
    (d / "units").write_text("sil\naa\nb\nk\n")


@pytest.fixture(scope="module")
def worker_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_worker")
    write_corpus(d)
    (d / "w.py").write_text(WORKER)
    spawn_ranks([str(d / "w.py"), str(d)], 1, distributed=False)
    spawn_ranks([str(d / "w.py"), str(d)], 2)
    load = lambda name: json.loads((d / name).read_text())
    return load("w1_0.json"), [load("w2_0.json"), load("w2_1.json")]


def test_summed_gradients_and_bn_stats_match_one_rank(worker_runs):
    """Gradients summed over 2 ranks (each a partial sum of the global
    loss's), BN's running statistics from the global batch's kept rows,
    and the Adam step: 1 rank's within 1e-5 abs / 1e-4 rel.  A rank that
    averaged the gradients or divided by its own row count would be off
    by a factor (rank 1 keeps 1 of its 4 rows).  The conv biases feed a
    train-mode BatchNorm, so their gradient is exactly 0 on every rank
    (autograd's rounding noise would make Adam's first step about
    lr * sign(rounding), a sign that differs between 1 and 2 ranks)."""
    one, (r0, r1) = worker_runs
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-5)
    for part in ("grad", "stats", "param"):
        assert r0[part].keys() == one[part].keys()
        for k in one[part]:
            assert r0[part][k] == r1[part][k], (part, k)
            if part == "grad" and k.startswith("conv.conv") \
                    and k.endswith(".bias"):
                assert r0[part][k] == one[part][k] == [0.0] * len(
                    one[part][k]), k
            np.testing.assert_allclose(r0[part][k], one[part][k], atol=1e-5,
                                       rtol=1e-4, err_msg=f"{part} {k}")


def test_row_sharded_gather_equals_replicated(worker_runs):
    """Each rank's rows of every global batch, assembled from the rows
    the ranks own, equal bit for bit the replicated cache's index_select
    (checked in the worker, -0.0 included); the two ranks' slices put
    together are the one-process loader's batches; each rank holds half
    of every bucket's rows (padded to even)."""
    one, (r0, r1) = worker_runs
    for wire in ("float32", "bfloat16"):
        got = [a + b for a, b in zip(r0["gather"][wire], r1["gather"][wire])]
        assert got == one["gather"][wire], wire
    assert r0["bytes"] == r1["bytes"] >= one["bytes"]
    assert r0["bytes_per_device"] == r0["bytes"] // 2
    assert one["bytes_per_device"] == one["bytes"]


def test_ranks_draw_other_dropout_masks_and_the_same_weight_noise(
        worker_runs):
    one, (r0, r1) = worker_runs
    assert r0["mask"] != r1["mask"]
    assert r0["fused_mask"] != r1["fused_mask"]
    # rank 0 keeps the one-process stream
    assert r0["mask"] == one["mask"]
    assert r0["fused_mask"] == one["fused_mask"]
    assert r0["noise"] == r1["noise"] == one["noise"]
    assert any(np.abs(v).max() > 0 for v in map(np.asarray,
                                                r0["noise"].values()))


# ------------------------------------------------ 3. against mdd_tpu
SMALL = dict(input_dim=24, num_class=12, rnn_hidden_size=16, rnn_layers=2,
             conv_channels=(4, 4), text_embed_size=8, text_vocab_size=16,
             dropout=0.0)

JAX_WORKER = textwrap.dedent('''\
    import json, os, sys
    import numpy as np, torch
    from mdd_tpu_torch.parallel import mesh
    mesh.init_distributed("cpu")
    from mdd_tpu_torch.data.dataset import Batch
    from mdd_tpu_torch.models.ctc_model import ModelConfig
    from mdd_tpu_torch.train.loop import Trainer

    d = sys.argv[1]
    r, n = mesh.process_index(), mesh.process_count()
    cfg = ModelConfig(**json.loads(open(os.path.join(d, "cfg.json")).read()))
    tr = Trainer(cfg, seed=0, device="cpu")
    tr.model.load_state_dict(torch.load(os.path.join(d, "w.pt")))
    data = np.load(os.path.join(d, "batches.npz"))
    b = data["inputs"].shape[1] // n
    sl = slice(r * b, (r + 1) * b)
    losses = []
    for s in range(data["inputs"].shape[0]):
        batch = Batch(data["inputs"][s, sl], data["fracs"][s, sl],
                      data["targets"][s, sl], data["tsizes"][s, sl],
                      data["trans"][s, sl], data["trsizes"][s, sl],
                      ["u"] * b, score_mask=data["valid"][s, sl])
        losses.append(tr.run_epoch([batch], 1, True, log=lambda *_: None)[1])
    with open(os.path.join(d, f"l{r}.json"), "w") as f:
        json.dump(losses, f)
    mesh.shutdown()
''')


def test_two_ranks_match_mdd_tpu_trainer(tmp_path):
    """Three train steps of 2 ranks x 4 rows against mdd_tpu's Trainer on
    one device over the same 8-row global batches and weights (the last
    batch with 3 rows masked out): loss within 1e-5 on the first step and
    1e-4 after three."""
    cfg = ModelConfig(**SMALL)
    params, stats = random_flax_variables(cfg, seed=4)
    torch.save(flax_to_torch(params, stats), tmp_path / "w.pt")
    (tmp_path / "cfg.json").write_text(json.dumps(SMALL))
    rng = np.random.default_rng(9)
    steps, b, t, l = 3, 8, 16, 4
    data = dict(
        inputs=rng.standard_normal((steps, b, t, 24)).astype(np.float32),
        fracs=rng.uniform(0.6, 1.0, (steps, b)).astype(np.float32),
        targets=rng.integers(2, 12, (steps, b, l)).astype(np.int32),
        tsizes=rng.integers(2, l + 1, (steps, b)).astype(np.int32),
        trans=rng.integers(2, 12, (steps, b, l)).astype(np.int32),
        trsizes=np.full((steps, b), l, np.int32),
        valid=np.ones((steps, b), bool))
    data["valid"][-1, 5:] = False
    np.savez(tmp_path / "batches.npz", **data)

    jt = JaxTrainer(JaxConfig(**SMALL), n_devices=1, seed=0)
    jt.state = jax.device_put(
        jt.state.replace(params=jax.tree.map(jnp.asarray, params),
                         batch_stats=jax.tree.map(jnp.asarray, stats)),
        replicated(jt.mesh))
    want = []
    for s in range(steps):
        batch = JaxBatch(data["inputs"][s], data["fracs"][s],
                         data["targets"][s], data["tsizes"][s],
                         data["trans"][s], data["trsizes"][s], ["u"] * b,
                         score_mask=data["valid"][s])
        want.append(jt.run_epoch([batch], 1, True, log=lambda *_: None)[1])

    (tmp_path / "w.py").write_text(JAX_WORKER)
    spawn_ranks([str(tmp_path / "w.py"), str(tmp_path)], 2)
    got = [json.loads((tmp_path / f"l{r}.json").read_text()) for r in (0, 1)]
    assert got[0] == got[1]
    assert got[0][0] == pytest.approx(want[0], rel=1e-5)
    np.testing.assert_allclose(got[0], want, rtol=1e-4)


# ------------------------------------------------ the backend rule
@pytest.mark.parametrize("device,cards,local_world,local_rank,want", [
    ("cpu", 0, 2, 1, ("gloo", "cpu")),
    ("cpu", 4, 2, 1, ("gloo", "cpu")),
    ("cuda", 1, 2, 1, ("gloo", "cuda:0")),       # two ranks share a card
    ("cuda", 4, 8, 5, ("gloo", "cuda:1")),
    ("cuda", 2, 2, 1, ("nccl", "cuda:1")),       # a card a rank
    ("cuda", 8, 4, 3, ("nccl", "cuda:3")),
])
def test_backend_rule(monkeypatch, device, cards, local_world, local_rank,
                      want):
    """nccl when every local rank has a card of its own (rank r on
    cuda:r), gloo when ranks share cards or run on the CPU; the group
    gets the environment's rank and size and a timeout."""
    import torch.distributed as dist

    from mdd_tpu_torch.parallel import mesh

    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setenv("RANK", str(10 + local_rank))
    monkeypatch.setenv("WORLD_SIZE", "16")
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    dev = mesh.init_distributed(device)
    assert (calls[0][0], str(dev)) == want
    kw = calls[0][1]
    assert (kw["rank"], kw["world_size"]) == (10 + local_rank, 16)
    assert kw["timeout"].total_seconds() == mesh.INIT_TIMEOUT_S


def test_no_card_for_cuda_raises(monkeypatch):
    from mdd_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for v, val in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                   ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(v, val)
    with pytest.raises(SystemExit, match="no CUDA device.*--device cpu"):
        mesh.init_distributed("cuda")
