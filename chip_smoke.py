"""Drive the PyTorch + CUDA port (mdd_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py            # from the repo root, on a machine with a card

Phases, each printed as it ends; any failure raises and exits non-zero:

1. build    nvcc every CUDA source of the port for sm_90a (in parallel):
            lstm_fwd.cu, lstm_bwd.cu, dropout.cu, and mma_rate.cu (the
            mma.sync-rate yardstick of ops/mma_rate.py, no kernel of
            the model's path).
2. kernel   lstm_fwd against its plain PyTorch version on the card, at the
            serving and training shapes (H=384, B in {1, 4, 16, 64}, T' in
            {16, 80, 128}) and at B=24, 256 and 512 (two unit groups a
            block, four and eight launches), float32 and bfloat16.
3. kernel-bwd  lstm_bwd against its plain version at the training shapes
            (H=384, B in {1, 4, 16, 24, 64}, T' in {16, 80, 128}) and at
            B=256, 300 and 512 (each as several recurrence launches, 300
            with a ragged last one; the same bits twice), float32 and
            bfloat16.
4. model    the full-width flagship model (model_config of
            checkpoints/syn_full/best.meta.json) with seeded weights made in
            the flax layout and passed through convert.flax_to_torch: one
            forward with the kernel, one with the plain LSTM, log-probs
            compared.
5. serve    the serving path a user runs: seeded 16 kHz wavs, their CMVN
            stats, a 41-unit inventory, a YAML config and a port checkpoint
            on disk, then `python -m mdd_tpu_torch serve` in-process on JSON
            request lines, and the engine it builds on groups that batch 1,
            4 and 16 requests.  Every response must be ok; the kernel's
            launch counter, zeroed just before, must cover all 4 acoustic
            layers of every forward.
6. profile  torch.profiler over batch-1 requests: device busy share and
            the kernels that take the device time.
7. model-grad  the full-width model, one Trainer step at B=8 (dropout 0)
            with the kernels and one with the plain LSTM: loss, every
            parameter's gradient and the updated BN statistics compared.
8. train    the training path a user runs: a seeded corpus (512 train, 64
            dev utterances of 16-40 phones of the 41-unit inventory, 81-dim
            band-template features) written with the port's ArkScpWriter, a
            YAML of the flagship recipe, then `python -m mdd_tpu_torch train`
            in-process for one epoch and `--resume` for a second.  Losses
            finite and falling, `best` and `latest` on disk, the launch
            counters (zeroed just before) covering every layer of every
            step; then the step time at B=64.
9. profile-train  torch.profiler over 3 train steps: device busy share and
            the ops that take the device time.
10. timing  one BiLSTM layer at B=1, 16 and 64, T'=80: the forward kernel
            (and its plan), its plain version, its bound, the port's layer
            and one torch.nn.LSTM call (a whole layer, the yardstick); the
            backward at B=16, 64, 256 and 512, T'=80, its plain version,
            its launches one by one (the pre-activation product, the
            recurrence, the dW_hh product: ms and effective TFLOP/s), and
            the backward of one torch.nn.LSTM (forward+backward minus
            forward) as the yardstick only.
11. kernel-dropout  fused_dropout against its plain version, bit for bit,
            float32 and bfloat16, rates 0.1 / 0.2 / 0.5, at the 3 site
            shapes of a B=64, T=220 (T'=110) step (conv0 64x32x220x122,
            conv1 64x32x110x61, BiLSTM 110x64x768) and at sizes that are
            not multiples of 4 (1, 3, 1023, 7x129), past one wave of
            resident threads (9,000,001) and on storage one element off
            16-byte alignment; kept share within 4 sigma of keep; the
            autograd gradient = mask / keep * dy with the forward's mask;
            two seeds, two masks.
12. train-fused  the flagship model with use_fused_dropout=True through
            cli._build_loader, cli.build_trainer and Trainer.fit for 3
            epochs of the corpus (seconds; after one epoch the posteriors
            are too flat to score a beam with an LM against greedy): loss
            finite and falling, 12 dropout launches a train step (6 sites,
            forward and backward), `best` on disk with use_fused_dropout
            in its meta; then the step time and the device time of a step
            with fused and with plain dropout, in turns.
13. train-bf16  the flagship recipe with compute_dtype bfloat16 (the
            shipped recipes' dtype) and use_fused_dropout=True, through the
            entry points of phase 12 for one epoch: losses finite and
            falling, every layer of every step on the kernels, the step
            median; then one Trainer step of the full-width model at
            bench.py's cell, B=512 x 160 input frames (T'=80, 48 canonical
            phones) in bfloat16: loss finite, one lstm_bwd count a layer
            (its recurrence in several launches), the step time.
14. evaluate  `train-lm` on the training labels, then `evaluate` (beam
            width 10 + that LM at alpha 0.5, device front end, the dev
            split as test split) on the `best` of phase 12 with
            --dump-dir, `evaluate --lm-alpha 0`, `evaluate --decode-type
            Greedy`, and `mdd-result` on the beam + LM dumps, all
            in-process: the reports parse, the canonical total equals the
            dump's phones, mdd-result's PER is evaluate's, lstm_fwd
            launched 4 times a forward, the three PERs close; on one
            batch of that model's log-probs the
            device beam against the host beam (decode/beam.py), at least
            95% of the sequences identical.
15. profile-evaluate  evaluate_model over the 512 training utterances, beam
            and greedy: utterances per second, and torch.profiler's device
            busy share over one beam pass; the beam alone at B=64, T'=110,
            K=10, C=43 (ms a batch and a frame); fused_dropout at the 3
            site shapes in float32 and bfloat16: a call (CUDA events) and
            its kernel's device time (torch.profiler) beside its bound (the
            larger of bytes and integer operations), its plain version and
            F.dropout (the yardstick only; ops/dropout_time.py).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Exits 2 without a CUDA device, or when run
outside a checkout of the repo.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "_smoke"
SEED = 0
H = 384
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # kernel vs plain, hs and cs:
# float32 differs in the summation order of the recurrent dot and in its
# three TF32 passes (~2^-20 of a product); bfloat16 rounds h every step, so
# a 1-ulp rounding (2^-8) can carry on
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # kernel vs plain, dx_proj
# and dW_hh, each relative to its largest magnitude: float32 sums run in
# another order (dh as partial sums of up to H/8 blocks, dW over all T*B
# rows at once instead of step by step) and every float32 product is three
# TF32 passes on the tensor cores (~2^-20 of a product); bfloat16 rounds
# dgates, so a 1-ulp rounding (2^-8) can carry into the earlier steps
MODEL_TOL = 1e-4   # full-model log-probs, float32, kernel vs plain LSTM
GRAD_TOL = 1e-3    # full-model gradients, float32, kernels vs plain LSTM,
# each relative to its tensor's largest magnitude: the sums of both kernels
# run in another order and the differences pass through 4 layers of
# train-mode BatchNorm and the recurrences
ZERO_ULPS = 64     # a tensor whose plain gradient stays within this many
# float32 ulps of the largest gradient is 0 up to rounding (a bias that
# feeds a train-mode BatchNorm, which subtracts the batch mean): its
# relative error is noise, so both runs' gradients are held below that
TRAIN_UTTS, DEV_UTTS, BATCH = 512, 64, 64
FUSED_EPOCHS = 3
PER_GAP = 5.0      # beam (with and without the LM) vs greedy PER, percentage
# points: the LM trained on the corpus's near-uniform phone strings acts as
# an insertion penalty of ~1.8 nats a phone at alpha 0.5, which a model of
# 3 epochs mostly outweighs
BEAM_MATCH = 0.95  # device beam vs host beam, share of identical sequences
# (float32 against float64 scores can reorder near-tied prefixes)
# H100 SXM published peaks (NVIDIA data sheet), dense, at 700 W
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
UNITS = ["sil", "err", "aa", "ae", "ah", "ao", "aw", "ay", "b", "ch", "d",
         "dh", "eh", "er", "ey", "f", "g", "hh", "ih", "iy", "jh", "k", "l",
         "m", "n", "ng", "ow", "oy", "p", "r", "s", "sh", "t", "th", "uh",
         "uw", "v", "w", "y", "z", "zh"]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float32."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def bound(nbytes: float, flops: float, dtype: str) -> tuple:
    """(least ms, what bounds it) for moving nbytes and doing flops."""
    by_bytes = nbytes / PEAK_BYTES_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes > by_ops
                                   else "operations")


def lstm_bwd_bound_ms(t: int, b: int, h: int, dtype: str) -> tuple:
    """Least time for the backward on these inputs: x_proj, hs, cs and dhs
    (float32) read once, dx_proj written once, w_hh read and dW_hh (float32)
    written once; three times the forward's dots (gate recompute, dh_{t-1},
    dW_hh) plus ~20 operations of gate math per hidden unit and step."""
    elt = 4 if dtype == "float32" else 2
    seq = t * 2 * b
    nbytes = (elt * (seq * 4 * h * 2 + seq * h * 2 + 2 * h * 4 * h)
              + 4 * (seq * h + 2 * h * 4 * h))
    flops = 3 * 2 * seq * h * 4 * h + 20 * seq * h
    return bound(nbytes, flops, dtype)


def lstm_bound_ms(t: int, b: int, h: int, dtype: str) -> tuple:
    """Least time for the recurrence on these inputs: x_proj and w_hh read
    once, hs and cs written once; the recurrent dots plus the gate adds."""
    elt = 4 if dtype == "float32" else 2
    nbytes = elt * (t * 2 * b * 4 * h + 2 * h * 4 * h + 2 * t * 2 * b * h)
    flops = 2 * t * 2 * b * h * 4 * h + t * 2 * b * 4 * h + 4 * t * 2 * b * h
    return bound(nbytes, flops, dtype)


def phase_build() -> None:
    from mdd_tpu_torch.ops import build

    t0 = time.time()
    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    procs = [(s, build.start_build(s)) for s in sources]   # all at once
    for source, proc in procs:
        out = build.finish_build(source, proc)
        for line in out.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  ptxas {source}: {line.strip()}")
    log(f"[build] {len(sources)} source(s) {sources} in "
        f"{time.time() - t0:.2f} s")


def phase_kernel(torch) -> dict:
    from mdd_tpu_torch.ops.lstm_cuda import (
        lstm_fwd_kernel,
        lstm_seq_fwd_reference,
    )

    g = torch.Generator().manual_seed(SEED)
    worst = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        worst[dtype] = 0.0
        # the serving and training shapes, then a batch the kernel splits
        # over two unit groups a block and two that take several launches
        cases = [(b, t) for b in (1, 4, 16, 64) for t in (16, 80, 128)]
        for b, t in cases + [(24, 16), (256, 16), (512, 4)]:
            x_proj = (torch.randn((t, 2, b, 4 * H), generator=g) * 0.5
                      ).to("cuda", dt)
            w_hh = ((torch.rand((2, H, 4 * H), generator=g) * 2 - 1)
                    / H ** 0.5).to("cuda", dt)
            hs, cs = lstm_fwd_kernel(x_proj, w_hh)
            torch.cuda.synchronize()
            ref_hs, ref_cs = lstm_seq_fwd_reference(x_proj, w_hh)
            err = max((hs.float() - ref_hs.float()).abs().max().item(),
                      (cs.float() - ref_cs.float()).abs().max().item())
            log(f"  lstm_fwd {dtype} B={b} T'={t}: max |hs, cs - plain| "
                f"= {err:.3e}")
            if not err <= TOL[dtype]:
                raise AssertionError(
                    f"lstm_fwd {dtype} B={b} T'={t} differs from its "
                    f"plain version by {err} > {TOL[dtype]}")
            worst[dtype] = max(worst[dtype], err)
    log(f"[kernel] lstm_fwd matches lstm_seq_fwd_reference: float32 max err "
        f"{worst['float32']:.3e} (tol {TOL['float32']}), bfloat16 "
        f"{worst['bfloat16']:.3e} (tol {TOL['bfloat16']})")
    return worst


def phase_kernel_bwd(torch) -> dict:
    """lstm_bwd against lstm_seq_bwd_reference at the training shapes, on
    saved (hs, cs) of the plain forward and a random cotangent."""
    from mdd_tpu_torch.ops.lstm_cuda import (
        lstm_bwd_kernel,
        lstm_seq_bwd_reference,
        lstm_seq_fwd_reference,
    )

    g = torch.Generator().manual_seed(SEED + 1)
    worst = {}
    # the training shapes, then batches whose recurrence runs as several
    # launches (300: a ragged last one; 512: bench.py's batch)
    cases = [(b, t) for b in (1, 4, 16, 24, 64) for t in (16, 80, 128)]
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        worst[dtype] = 0.0
        for b, t in cases + [(256, 16), (300, 8), (512, 8)]:
            x_proj = (torch.randn((t, 2, b, 4 * H), generator=g) * 0.5
                      ).to("cuda", dt)
            w_hh = ((torch.rand((2, H, 4 * H), generator=g) * 2 - 1)
                    / H ** 0.5).to("cuda", dt)
            dhs = torch.randn((t, 2, b, H), generator=g).cuda()
            hs, cs = lstm_seq_fwd_reference(x_proj, w_hh)
            before = lstm_bwd_kernel.launches
            dxp, dw = lstm_bwd_kernel(x_proj, w_hh, hs, cs, dhs)
            torch.cuda.synchronize()
            if lstm_bwd_kernel.launches != before + 1:
                raise AssertionError("lstm_bwd did not count its launch")
            plan = lstm_bwd_kernel.plan(t, b, H, dt)
            if b >= 256:
                again = lstm_bwd_kernel(x_proj, w_hh, hs, cs, dhs)
                if not (torch.equal(dxp, again[0])
                        and torch.equal(dw, again[1])):
                    raise AssertionError(f"lstm_bwd B={b} changed its bits "
                                         "from one run to the next")
            ref_dxp, ref_dw = lstm_seq_bwd_reference(x_proj, w_hh, hs, cs,
                                                     dhs)
            errs = [rel_err(dxp, ref_dxp), rel_err(dw, ref_dw)]
            abs_err = max((dxp.float() - ref_dxp.float()).abs().max(),
                          (dw - ref_dw).abs().max()).item()
            log(f"  lstm_bwd {dtype} B={b} T'={t}: max |dx_proj - plain| "
                f"/ max |plain| = {errs[0]:.3e}, dW_hh {errs[1]:.3e}; "
                f"max abs err {abs_err:.3e}; {plan['launches']} recurrence "
                f"launch(es) of {plan['chunk_rows']} rows")
            if not max(errs) <= BWD_TOL[dtype]:
                raise AssertionError(
                    f"lstm_bwd {dtype} B={b} T'={t} differs from its "
                    f"plain version by {max(errs)} > {BWD_TOL[dtype]}")
            worst[dtype] = max(worst[dtype], *errs)
            worst[dtype + "_abs"] = max(worst.get(dtype + "_abs", 0.0),
                                        abs_err)
    log(f"[kernel-bwd] lstm_bwd matches lstm_seq_bwd_reference: float32 max "
        f"rel err {worst['float32']:.3e} (tol {BWD_TOL['float32']}), "
        f"bfloat16 {worst['bfloat16']:.3e} (tol {BWD_TOL['bfloat16']})")
    return worst


def phase_model(torch):
    from mdd_tpu_torch.convert import flax_to_torch, random_flax_variables
    from mdd_tpu_torch.models.ctc_model import (
        CTCAttentionModel,
        model_config_from_meta,
    )

    meta = json.loads((ROOT / "checkpoints" / "syn_full"
                       / "best.meta.json").read_text())
    cfg = model_config_from_meta(meta)
    if not cfg.use_pallas_lstm:
        raise AssertionError("the flagship config runs the fused LSTM")
    state = flax_to_torch(*random_flax_variables(cfg, SEED))
    models = {}
    for name, use in (("kernel", True), ("plain", False)):
        m = CTCAttentionModel(dataclasses.replace(cfg, use_pallas_lstm=use))
        m.load_state_dict(state, strict=True)
        models[name] = m.to("cuda").eval()
    rng = torch.Generator().manual_seed(SEED)
    b, t, l = 4, 160, 16
    feats = torch.randn((b, t, cfg.input_dim), generator=rng).cuda()
    trans = torch.randint(2, cfg.num_class, (b, l), generator=rng).cuda()
    lengths = torch.tensor([16, 11, 5, 1]).cuda()
    with torch.inference_mode():
        out = {k: m(feats, trans, lengths) for k, m in models.items()}
    lp = out["kernel"]
    want = (cfg.output_frames(t), b, cfg.num_class)
    if tuple(lp.shape) != want or not torch.isfinite(lp).all():
        raise AssertionError(f"log-probs {tuple(lp.shape)} (want {want}) "
                             "or not finite")
    err = (lp - out["plain"]).abs().max().item()
    log(f"[model] full-width CTCAttentionModel ({models['kernel'].num_params()}"
        f" params), B={b} T'={want[0]}: kernel vs plain LSTM log-probs max "
        f"err {err:.3e} (tol {MODEL_TOL})")
    if not err <= MODEL_TOL:
        raise AssertionError(f"model log-probs differ by {err}")
    return cfg, meta, state


def write_serving_files(cfg, meta, state) -> dict:
    """Wavs, units, CMVN, config and checkpoint under WORK."""
    import numpy as np

    from mdd_tpu_torch.frontend.cmvn import CmvnStats, write_kaldi_cmvn_text
    from mdd_tpu_torch.frontend.pipeline import BatchedFbank
    from mdd_tpu_torch.frontend.wav import read_audio, write_wav
    from mdd_tpu_torch.train.checkpoint import save_checkpoint

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir()
    rng = np.random.default_rng(SEED)
    paths = []
    for i, secs in enumerate(np.linspace(0.6, 3.2, 8)):
        n = int(secs * 16000)
        tt = np.arange(n) / 16000.0
        sig = sum(a * np.sin(2 * np.pi * f * tt) for a, f in
                  zip(rng.uniform(500, 4000, 3), rng.uniform(100, 3000, 3)))
        sig = sig * np.hanning(n) + 300 * rng.standard_normal(n)
        path = str(WORK / f"w{i}.wav")
        write_wav(path, sig.astype(np.float32), 16000)
        paths.append(path)
    (WORK / "units").write_text("\n".join(UNITS) + "\n")
    feats = BatchedFbank(device="cuda")([read_audio(p)[0] for p in paths])
    write_kaldi_cmvn_text(CmvnStats.accumulate(feats), str(WORK / "cmvn.txt"))
    save_checkpoint(str(WORK / "ckpt"), "best", state,
                    {"model_config": meta["model_config"]})
    (WORK / "serve.yaml").write_text(
        f"exp_name: smoke\nvocab_file: {WORK / 'units'}\n"
        "decode_type: Greedy\nleft_ctx: 0\nright_ctx: 2\n"
        "n_skip_frame: 2\nn_downsample: 2\n")
    canon = [[UNITS[k] for k in rng.integers(2, len(UNITS), rng.integers(3, 9))]
             for _ in paths]
    return {"paths": paths, "canonical": canon,
            "args": ["serve", "--conf", str(WORK / "serve.yaml"),
                     "--checkpoint", str(WORK / "ckpt"),
                     "--cmvn", str(WORK / "cmvn.txt"), "--device", "cuda"]}


def request(files, i, rid=None) -> str:
    return json.dumps({"id": rid if rid is not None else i,
                       "wav": files["paths"][i], "word": f"w{i}",
                       "canonical": files["canonical"][i]})


def check_ok(resps, n) -> None:
    if len(resps) != n:
        raise AssertionError(f"{len(resps)} responses to {n} requests")
    for r in resps:
        if r.get("status") != "ok" or not {
                "score", "canonical_row", "ops_row", "decoded_row",
                "insertion_faults", "substitution_faults",
                "deletion_faults"} <= r.keys() or not 0 <= r["score"] <= 100:
            raise AssertionError(f"bad response {r}")


def phase_serve(files, card: str):
    """The main path; returns (the kernel launches it made, the engine)."""
    from mdd_tpu_torch import cli
    from mdd_tpu_torch.ops.lstm_cuda import lstm_fwd_kernel
    from mdd_tpu_torch.serve import handle_requests

    n_files = len(files["paths"])
    lstm_fwd_kernel.launches = 0
    # (a) the serve subcommand, as `python -m mdd_tpu_torch serve` runs it
    lines = [request(files, i % n_files, rid=i) for i in range(2 * n_files)]
    out, err = io.StringIO(), io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO("\n".join(lines) + "\n")
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(files["args"] + ["--quiet"])
    finally:
        sys.stdin = stdin
    if rc != 0:
        raise AssertionError(f"serve exited {rc}: {err.getvalue()}")
    check_ok([json.loads(l) for l in out.getvalue().splitlines()], len(lines))
    tail = err.getvalue().strip().splitlines()[-1]
    cli_forwards = int(tail.split(" in ")[1].split()[0])
    log(f"[serve] subcommand: {len(lines)} requests ok; {tail}")
    # (b) the engine it builds, on groups of 1, 4 and 16 requests
    engine = cli._build_engine(cli.build_parser().parse_args(files["args"]))
    engine.warmup()
    singles = []
    for i in range(n_files):
        t0 = time.perf_counter()
        resps = handle_requests(engine, [request(files, i)])
        singles.append(time.perf_counter() - t0)
        check_ok(resps, 1)
    for size in (4, 16):
        group = [request(files, n_files // 2, rid=k) for k in range(size)]
        t0 = time.perf_counter()
        resps = handle_requests(engine, group)
        dt = time.perf_counter() - t0
        check_ok(resps, size)
        if {r["batch"] for r in resps} != {size}:
            raise AssertionError("group was not served as one batch")
        log(f"[serve] batch of {size}: {dt * 1e3:.2f} ms for the group "
            f"({card})")
    resps = handle_requests(engine, [request(files, i)
                                     for i in range(n_files)])
    check_ok(resps, n_files)
    forwards = cli_forwards + engine.session.forwards
    launches = lstm_fwd_kernel.launches
    log(f"[serve] p50 request latency, batch 1, wavs 0.6-3.2 s: "
        f"{statistics.median(singles) * 1e3:.2f} ms ({card})")
    log(f"[serve] lstm_fwd launches {launches} over {forwards} model "
        f"forwards (4 acoustic BiLSTM layers each)")
    if launches < 4 * forwards or forwards == 0:
        raise AssertionError(f"{launches} kernel launches for {forwards} "
                             "forwards: a layer bypassed the kernel")
    return launches, engine


def phase_profile(torch, engine, files, card: str) -> None:
    """Where a batch-1 request's time goes: device busy share of the wall
    clock and the kernels that take the most device time (torch.profiler
    over one request per wav, after the serve phase warmed everything)."""
    from torch.profiler import ProfilerActivity, profile

    from mdd_tpu_torch.serve import handle_requests

    n = len(files["paths"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            handle_requests(engine, [request(files, i)])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, wall_us, "profile", f"{n} batch-1 requests", card)


def report_profile(prof, wall_us: float, tag: str, what: str,
                   card: str) -> None:
    """Device busy share of the wall clock and the top device ops."""
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        raise AssertionError("the profiler saw no device time")
    log(f"[{tag}] {what}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"{sum(e.count for e in events)} device ops ({card})")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # the top ten, and below them every kernel of the package's own
    for e in ranked[:10] + [e for e in ranked[10:]
                            if "lstm_" in e.key or "dropout_kernel" in e.key]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")


def write_corpus(split: str, n: int, seed: int) -> tuple:
    """n utterances of 16-40 phones between two "sil" of the 41-unit
    inventory, each phone a fixed band template over the 81 fbank bins for
    6-15 frames plus noise (T' = 47-110 after skip and conv), the labels
    the canonical phones with 15% substituted; -> (scp, lab, trans)."""
    import numpy as np

    from mdd_tpu_torch.frontend.kaldi_io import ArkScpWriter

    rng = np.random.default_rng(seed)
    templates = {}
    for k, unit in enumerate(UNITS):
        t_rng = np.random.default_rng(1000 + k)
        base = np.full(81, -1.0, np.float32)
        for c in t_rng.choice(np.arange(4, 77), size=3, replace=False):
            w = int(t_rng.integers(2, 5))
            base[c - w:c + w] = 2.0 + t_rng.uniform(0.0, 1.0)
        templates[unit] = base
    content = [u for u in UNITS if u not in ("sil", "err")]
    root = WORK / "corpus"
    root.mkdir(parents=True, exist_ok=True)
    scp, lab, trn = (str(root / f"{split}.{x}")
                     for x in ("scp", "phn_text", "trans"))
    with ArkScpWriter(str(root / f"{split}.ark"), scp) as w, \
            open(lab, "w") as fl, open(trn, "w") as ft:
        for i in range(n):
            canon = (["sil"] + [content[k] for k in rng.integers(
                0, len(content), rng.integers(16, 41))] + ["sil"])
            actual = [content[rng.integers(len(content))]
                      if 0 < j < len(canon) - 1 and rng.random() < 0.15
                      else p for j, p in enumerate(canon)]
            feats = np.concatenate([np.repeat(
                templates[p][None], rng.integers(6, 16), axis=0)
                for p in actual])
            feats += 0.35 * rng.standard_normal(feats.shape).astype(
                np.float32)
            w.write(f"{split}_{i:04d}", feats)
            fl.write(f"{split}_{i:04d} {' '.join(actual)}\n")
            ft.write(f"{split}_{i:04d} {' '.join(canon)}\n")
    return scp, lab, trn


def write_train_yaml(train, dev, epochs: int,
                     compute_dtype: str = "float32") -> str:
    """The flagship recipe (conf/ctc_config.yaml's, in float32 unless
    said) on the streaming loader, over the seeded corpus."""
    fields = {
        "exp_name": "smoke_train", "checkpoint_dir": str(WORK / "ckpt"),
        "seed": 1234, "vocab_file": str(WORK / "units"),
        "train_scp_path": train[0], "train_lab_path": train[1],
        "train_trans_path": train[2], "valid_scp_path": dev[0],
        "valid_lab_path": dev[1], "valid_trans_path": dev[2],
        "left_ctx": 0, "right_ctx": 2, "n_skip_frame": 2, "n_downsample": 2,
        "feature_dim": 81, "rnn_hidden_size": H, "rnn_layers": 4,
        "drop_out": 0.2, "channel": "[(1, 32), (32, 32)]",
        "kernel_size": "[(3, 3), (3, 3)]", "stride": "[(1, 2), (2, 2)]",
        "padding": "[(1, 1), (1, 1)]", "use_text_attention": True,
        "use_pallas_lstm": True, "device_frontend": True,
        "wire_dtype": "bfloat16", "compute_dtype": compute_dtype,
        "device_cache": False, "init_lr": 0.001, "num_epoches": epochs,
        "end_adjust_acc": 2.0, "lr_decay": 0.5, "batch_size": BATCH,
        "weight_decay": 0.0005, "verbose_step": 1, "max_adjust_times": 8,
        "plateau_patience": 10, "augment_mode": 2, "mutation_prob": 0.1,
        "num_workers": 4}
    path = WORK / f"train{epochs}_{compute_dtype}.yaml"
    path.write_text("".join(f"{k}: {json.dumps(v)}\n"
                            for k, v in fields.items()))
    return str(path)


def phase_model_grad(torch, cfg, state, corpus) -> None:
    """One Trainer step of the full-width model at B=8, dropout 0, with
    the kernels and with the plain LSTM, from the same weights and batch."""
    from mdd_tpu_torch.data.dataset import BucketedLoader, SpeechDataset
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.train.loop import Trainer

    ds = SpeechDataset(Vocab.from_units_file(str(WORK / "units")), *corpus,
                       device_frontend=True)
    batch = next(iter(BucketedLoader(ds, 8)))
    out = {}
    for name, use in (("kernel", True), ("plain", False)):
        tr = Trainer(dataclasses.replace(cfg, use_pallas_lstm=use,
                                         dropout=0.0),
                     device="cuda", device_frontend=True)
        tr.model.load_state_dict(state, strict=True)
        acc = tr.train_step(tr.batch_arrays(batch),
                            torch.zeros(4, device="cuda"))
        out[name] = (acc.cpu(),
                     {n: p.grad for n, p in tr.model.named_parameters()},
                     dict(tr.model.named_buffers()))
    (acc_k, g_k, b_k), (acc_p, g_p, b_p) = out["kernel"], out["plain"]
    loss_err = abs(acc_k[0] - acc_p[0]).item() / abs(acc_p[0]).item()
    top = max(g.abs().max().item() for g in g_p.values())
    noise = ZERO_ULPS * torch.finfo(torch.float32).eps * top
    zero = {n for n, g in g_p.items() if g.abs().max().item() <= noise}
    zero_max = max((max(g_k[n].abs().max().item(), g_p[n].abs().max().item())
                    for n in zero), default=0.0) / top
    grad_err = {n: rel_err(g_k[n], g_p[n]) for n in g_p if n not in zero}
    stat_err = max(rel_err(b_k[n], b_p[n]) for n in b_p)
    worst = max(grad_err, key=grad_err.get)
    log(f"[model-grad] B=8 T'={batch.inputs.shape[1] // 4}: loss "
        f"{acc_k[0].item():.4f} vs {acc_p[0].item():.4f} (rel {loss_err:.2e}"
        f"), WER counts {acc_k[1:3].tolist()} vs {acc_p[1:3].tolist()}; "
        f"worst gradient {worst} rel err {grad_err[worst]:.3e} over "
        f"{len(grad_err)} tensors; 0 up to rounding in the plain run: "
        f"{sorted(zero)}, at most {zero_max:.2e} of the largest gradient in "
        f"either run (limit {ZERO_ULPS * torch.finfo(torch.float32).eps:.2e})"
        f"; BN statistics rel err {stat_err:.3e} (tol {GRAD_TOL})")
    if not (loss_err <= 1e-5 and grad_err[worst] <= GRAD_TOL
            and zero_max * top <= noise
            and stat_err <= GRAD_TOL and all(torch.isfinite(
                g).all() for g in g_k.values())):
        raise AssertionError("kernel and plain-LSTM train steps disagree")


def run_cli(args) -> str:
    """`python -m mdd_tpu_torch <args>` in this process; -> its stdout."""
    from mdd_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(args)
    if rc != 0:
        raise AssertionError(f"{args} exited {rc}")
    return out.getvalue()


def phase_train(torch, train, dev) -> tuple:
    """The training path; -> (lstm_fwd launches, lstm_bwd launches, the
    epoch-2 YAML)."""
    from mdd_tpu_torch.ops.lstm_cuda import lstm_bwd_kernel, lstm_fwd_kernel

    confs = [write_train_yaml(train, dev, e) for e in (1, 2)]
    lstm_fwd_kernel.launches = lstm_bwd_kernel.launches = 0
    t0 = time.perf_counter()
    out = run_cli(["train", "--conf", confs[0], "--device", "cuda"])
    out += run_cli(["train", "--conf", confs[1], "--device", "cuda",
                    "--resume"])
    wall = time.perf_counter() - t0
    fwd, bwd = lstm_fwd_kernel.launches, lstm_bwd_kernel.launches
    for line in out.splitlines():
        if "done" in line or "resumed" in line or "best dev" in line:
            log(f"[train]   {line}")
    losses = [float(v) for v in
              re.findall(r"total_loss(?::| =) (\S+?),", out)]
    first = float(re.search(r"Epoch = 1, step = 1, total_loss = (\S+?),",
                            out).group(1))
    ep2 = float(re.search(r"Epoch 2 Train done, total_loss: (\S+?),",
                          out).group(1))
    steps = -(-TRAIN_UTTS // BATCH) * 2
    forwards = steps + -(-DEV_UTTS // BATCH) * 2
    ckpt = WORK / "ckpt" / "smoke_train"
    log(f"[train] 2 epochs of {TRAIN_UTTS} utterances at B={BATCH} in "
        f"{wall:.1f} s (both runs' set-up included); "
        f"first step loss {first:.4f}, epoch-2 train loss {ep2:.4f}; "
        f"lstm_fwd launches {fwd} over {forwards} forwards, lstm_bwd "
        f"launches {bwd} over {steps} train steps")
    if not all(math.isfinite(v) for v in losses) or len(losses) < steps:
        raise AssertionError(f"losses not finite or missing: {losses}")
    if not ep2 < first:
        raise AssertionError(f"epoch-2 loss {ep2} is not below the first "
                             f"step's {first}")
    for name in ("best.pt", "best.meta.json", "latest.pt", "latest.opt.pt"):
        if not (ckpt / name).exists():
            raise AssertionError(f"{name} was not written")
    if bwd != 4 * steps or fwd < 4 * forwards:
        raise AssertionError(f"{fwd} forward / {bwd} backward launches for "
                             f"{forwards} forwards / {steps} train steps: a "
                             "layer bypassed the kernels")
    return fwd, bwd, confs[1]


def phase_step_time(torch, conf: str, card: str) -> None:
    """Train steps at B=64 on the corpus, each timed to a synchronize, then
    torch.profiler over 3 more: device busy share and top device ops."""
    from torch.profiler import ProfilerActivity, profile

    from mdd_tpu_torch import cli
    from mdd_tpu_torch.data.dataset import pad_batch_to
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.utils.config import load_config

    cfg = load_config(conf)
    vocab = Vocab.from_units_file(cfg.vocab_file)
    trainer = cli.build_trainer(cfg, vocab, "cuda")
    trainer.restore(cfg.checkpoint_dir, cfg.exp_name, "latest")
    loader = cli._build_loader(cfg, vocab, cfg.train_scp_path,
                               cfg.train_lab_path, cfg.train_trans_path,
                               train=True)
    batches = [pad_batch_to(b, BATCH) for b in loader]
    acc = torch.zeros(4, device="cuda")
    secs, audio = [], []
    for padded, valid in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = trainer.train_step(trainer.batch_arrays(padded, valid), acc)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        raw = padded.input_fracs[valid] * padded.inputs.shape[1]
        audio.append(float(raw.round().sum()) * 0.01)      # 10 ms frames
    med = statistics.median(secs)
    log(f"[train] step time at B={BATCH}, T' {batches[0][0].inputs.shape[1] // 4}"
        f"-{batches[-1][0].inputs.shape[1] // 4}: median {med * 1e3:.2f} ms "
        f"over {len(secs)} steps (min {min(secs) * 1e3:.2f}, max "
        f"{max(secs) * 1e3:.2f}); {sum(audio) / sum(secs):.1f} audio "
        f"seconds per second ({card})")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for padded, valid in batches[:3]:
            acc = trainer.train_step(trainer.batch_arrays(padded, valid), acc)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, wall_us, "profile-train",
                   f"3 train steps at B={BATCH}", card)


FWD_TIMING_BATCHES = (1, 16, 64)   # serving, serving groups, train/evaluate
# train at B=16 and 64; the quality recipe's 256 and bench.py's 512
BWD_TIMING_BATCHES = (16, 64, 256, 512)


def phase_timing(torch, card: str) -> tuple:
    """lstm_fwd at the batches of the main paths, then lstm_bwd at the
    training batches; -> ({B: forward timing}, {B: backward timing})."""
    g = torch.Generator().manual_seed(SEED)
    fwd = {b: timing_fwd(torch, 80, b, g, card) for b in FWD_TIMING_BATCHES}
    return fwd, {b: timing_bwd(torch, 80, b, g, card)
                 for b in BWD_TIMING_BATCHES}


def timing_fwd(torch, t: int, b: int, g, card: str) -> dict:
    """lstm_fwd at (T', B), float32: the kernel, its plain version, its
    bound, its plan; one BiLSTM layer through the port (input projection +
    kernel), through the plain loop, and one torch.nn.LSTM call as the
    yardstick: a whole layer, its input projection included."""
    from mdd_tpu_torch.ops.lstm import bilstm
    from mdd_tpu_torch.ops.lstm_cuda import (
        bilstm_cuda,
        lstm_fwd_kernel,
        lstm_seq_fwd_reference,
    )

    d_in = 2 * H
    s = H ** -0.5
    x = torch.randn((t, b, d_in), generator=g).cuda()
    w = [((torch.rand(shape, generator=g) * 2 - 1) * s).cuda()
         for shape in ((d_in, 4 * H), (H, 4 * H)) * 2]
    x_proj = (torch.randn((t, 2, b, 4 * H), generator=g) * 0.5).cuda()
    w_hh = torch.stack([w[1], w[3]])
    lib = torch.nn.LSTM(d_in, H, bidirectional=True, bias=False).cuda()
    with torch.inference_mode():
        hs, _ = lstm_fwd_kernel(x_proj, w_hh)
        err = (hs - lstm_seq_fwd_reference(x_proj, w_hh)[0]).abs().max().item()
        ms = cuda_ms(lambda: lstm_fwd_kernel(x_proj, w_hh), 50)
        plain_ms = cuda_ms(lambda: lstm_seq_fwd_reference(x_proj, w_hh), 10)
        layer_ms = cuda_ms(lambda: bilstm_cuda(x, *w), 50)
        layer_plain_ms = cuda_ms(lambda: bilstm(x, *w), 10)
        library_ms = cuda_ms(lambda: lib(x), 50)
    bnd, bound_by = lstm_bound_ms(t, b, H, "float32")
    plan = lstm_fwd_kernel.plan(b, H, torch.float32)
    log(f"[timing] float32, B={b} T'={t} H={H}: lstm_fwd kernel {ms:.4f} ms "
        f"({ms * 1e3 / t:.2f} us a step; {plan['blocks']} blocks of "
        f"{8 * plan['unit_groups']} units x 16 rows, "
        f"{plan['smem_bytes']} B shared, w_hh split at load "
        f"{bool(plan['split_w'])}, {plan['launches']} launch(es) of "
        f"{plan['chunk_rows']} rows, global barrier, no cluster), plain "
        f"lstm_seq_fwd_reference {plain_ms:.4f} ms, bound {bnd:.4f} ms "
        f"({bound_by}) ({card})")
    log(f"[timing] float32, B={b} T'={t}: BiLSTM layer (768 -> 2x384): port "
        f"bilstm_cuda {layer_ms:.4f} ms, plain bilstm {layer_plain_ms:.4f} "
        f"ms, torch.nn.LSTM (whole layer, input projection included) "
        f"{library_ms:.4f} ms ({card})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": bound_by, "library_ms": library_ms,
            "timing_err": err}


def timing_bwd(torch, t: int, b: int, g, card: str) -> dict:
    """lstm_bwd at (T', B), float32: the backward, its launches one by one
    (each product with its effective rate: the float32 operations of the
    product over its time), its plain version, its bound, and the backward
    of one cuDNN torch.nn.LSTM layer as the yardstick (its forward+backward
    minus its forward)."""
    from mdd_tpu_torch.ops.lstm_cuda import (
        lstm_bwd_kernel,
        lstm_fwd_kernel,
        lstm_seq_bwd_reference,
    )

    s = H ** -0.5
    x_proj = (torch.randn((t, 2, b, 4 * H), generator=g) * 0.5).cuda()
    w_hh = ((torch.rand((2, H, 4 * H), generator=g) * 2 - 1) * s).cuda()
    dhs = torch.randn((t, 2, b, H), generator=g).cuda()
    with torch.no_grad():
        hs, cs = lstm_fwd_kernel(x_proj, w_hh)
        fwd_ms = cuda_ms(lambda: lstm_fwd_kernel(x_proj, w_hh), 20)
        ms = cuda_ms(lambda: lstm_bwd_kernel(x_proj, w_hh, hs, cs, dhs), 20)
        plain_ms = cuda_ms(
            lambda: lstm_seq_bwd_reference(x_proj, w_hh, hs, cs, dhs), 3)
        k = lstm_bwd_kernel
        buffers = k.buffers(x_proj)
        part_ms = {name: cuda_ms(lambda: k.run_parts(
            x_proj, w_hh, hs, cs, dhs, buffers, part), 20)
            for name, part in (("all", k.ALL), ("z", k.Z_PRODUCT),
                               ("chain", k.CHAIN), ("dw", k.DW_PRODUCT))}
    plan = lstm_bwd_kernel.plan(t, b, H, torch.float32)
    dot_flops = 2 * 2 * b * H * 4 * H        # one step's dot, 2 directions
    z_tflops = t * dot_flops / part_ms["z"] / 1e9
    dw_tflops = (t - 1) * dot_flops / part_ms["dw"] / 1e9
    log(f"[timing] float32, B={b} T'={t}: lstm_bwd launches one by one: "
        f"pre-activation product {part_ms['z']:.4f} ms ({z_tflops:.1f} "
        f"TFLOP/s effective), recurrence {part_ms['chain']:.4f} ms "
        f"({part_ms['chain'] * 1e3 / max(t - 1, 1):.2f} us a step; "
        f"{plan['launches']} launch(es) of {plan['chunk_rows']} rows, "
        f"{plan['blocks']} blocks of {8 * plan['unit_groups']} units x "
        f"16 rows, {plan['smem_bytes']} B shared), "
        f"dW_hh product + reduce {part_ms['dw']:.4f} ms ({dw_tflops:.1f} "
        f"TFLOP/s effective, {plan['k_slices']} slices); with reused "
        f"buffers {part_ms['all']:.4f} ms ({card})")
    lib = torch.nn.LSTM(2 * H, H, bidirectional=True, bias=False).cuda()
    x = torch.randn((t, b, 2 * H), generator=g).cuda().requires_grad_()
    dy = torch.randn((t, b, 2 * H), generator=g).cuda()
    lib_fwd = cuda_ms(lambda: lib(x)[0], 20)
    lib_both = cuda_ms(lambda: lib(x)[0].backward(dy), 20)
    bnd, bound_by = lstm_bwd_bound_ms(t, b, H, "float32")
    log(f"[timing] float32, B={b} T'={t}: lstm_bwd kernel {ms:.4f} ms "
        f"(lstm_fwd at this shape {fwd_ms:.4f} ms), plain "
        f"lstm_seq_bwd_reference {plain_ms:.4f} ms, bound {bnd:.4f} ms "
        f"({bound_by}); torch.nn.LSTM layer backward (fwd+bwd "
        f"{lib_both:.4f} - fwd {lib_fwd:.4f}) {lib_both - lib_fwd:.4f} ms "
        f"({card})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": bound_by, "library_ms": lib_both - lib_fwd,
            "parts_ms": {name: part_ms[name] for name in ("z", "chain", "dw")},
            "product_tflops": {"z": z_tflops, "dw": dw_tflops}}


def phase_kernel_dropout(torch) -> float:
    """fused_dropout_kernel == fused_dropout_reference, bit for bit; ->
    the largest |kernel - plain| seen (0.0 or the phase raises)."""
    from mdd_tpu_torch.ops.dropout_cuda import (
        SITES,
        fused_dropout,
        fused_dropout_kernel,
        fused_dropout_reference,
    )

    g = torch.Generator().manual_seed(SEED + 4)
    shapes = list(SITES.items()) + [
        (f"n={n}", (n,)) for n in (1, 3, 1023, 9_000_001)] + [
        ("7x129", (7, 129))]
    worst, checked = 0.0, 0
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        bits = torch.int32 if dtype == "float32" else torch.int16
        for name, shape in shapes:
            x = torch.randn(shape, generator=g).to("cuda", dt)
            for rate in (0.1, 0.2, 0.5):
                seed = torch.randint(0, 2 ** 63 - 1, (1,), generator=g).cuda()
                before = fused_dropout_kernel.launches
                out = fused_dropout_kernel(x, seed, rate)
                torch.cuda.synchronize()
                if fused_dropout_kernel.launches != before + 1:
                    raise AssertionError("fused_dropout did not count its "
                                         "launch")
                ref = fused_dropout_reference(x, seed, rate)
                same = torch.equal(out.view(bits), ref.view(bits))
                err = (out.float() - ref.float()).abs().max().item()
                worst = max(worst, err)
                n, keep = x.numel(), 1.0 - rate
                kept = (out != 0).sum().item() / n
                sigma = (keep * rate / n) ** 0.5
                if not same:
                    raise AssertionError(
                        f"fused_dropout {dtype} {name} rate {rate} differs "
                        f"from its plain version (max abs {err})")
                if n >= 1000 and abs(kept - keep) > 4 * sigma:
                    raise AssertionError(
                        f"fused_dropout {dtype} {name} rate {rate}: kept "
                        f"share {kept} is over 4 sigma from {keep}")
                checked += 1
            log(f"  fused_dropout {dtype} {name} {tuple(shape)}: bit for bit "
                f"its plain version at rates 0.1, 0.2, 0.5; kept share at "
                f"0.5: {kept:.6f}")
        # storage one element off 16-byte alignment: the scalar path
        x = torch.randn(4099, generator=g).to("cuda", dt)[1:]
        seed = torch.tensor([SEED + 7], device="cuda")
        if not torch.equal(fused_dropout_kernel(x, seed, 0.2).view(bits),
                           fused_dropout_reference(x, seed, 0.2).view(bits)):
            raise AssertionError(f"fused_dropout {dtype} on unaligned "
                                 "storage differs from its plain version")
        checked += 1
    # autograd: the backward regenerates the forward's mask
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # x > 0, so that out != 0 is the mask (a normal draw of this size holds
    # a few exact zeros on the card)
    x = (torch.rand(SITES["bilstm"], device="cuda") + 0.5).requires_grad_()
    dy = torch.randn((BATCH, 110, 2 * H), device="cuda").transpose(0, 1)
    before = fused_dropout_kernel.launches
    out = fused_dropout(x, 0.2, gen)
    out.backward(dy)
    torch.cuda.synchronize()
    mask = out != 0
    scale = torch.tensor(1.0 / 0.8, dtype=torch.float32, device="cuda")
    made = fused_dropout_kernel.launches - before
    wrong = (x.grad != torch.where(mask, dy * scale, 0.0)).sum().item()
    if made != 2 or wrong:
        raise AssertionError(
            f"fused_dropout forward + backward made {made} launches (want "
            f"2) and {wrong} gradient entries differ from mask / keep * dy "
            "with the forward's mask")
    other = fused_dropout(x.detach(), 0.2, gen) != 0
    differ = (other != mask).float().mean().item()
    if not 0.2 < differ < 0.45:      # independent masks differ on 2 * .8 * .2
        raise AssertionError(f"two seeds' masks differ on {differ} of the "
                             "elements, not about 0.32")
    log(f"[kernel-dropout] fused_dropout equals fused_dropout_reference bit "
        f"for bit in {checked} cases (max abs err {worst}); gradient = mask "
        f"/ keep * dy; two seeds' masks differ on {differ:.4f} of the "
        "elements")
    return worst


def step_losses(lines) -> list:
    """Each step's own loss from the running means `run_epoch` prints."""
    means = [float(m.group(1)) for l in lines for m in
             [re.search(r"Epoch = 1, step = \d+, total_loss = (\S+?),", l)]
             if m]
    return [means[0]] + [(i + 1) * means[i] - i * means[i - 1]
                         for i in range(1, len(means))]


def phase_train_fused(torch, conf: str, card: str) -> dict:
    """One epoch with use_fused_dropout=True through the entry points
    `train` uses; -> the launch counts of the path and the YAML's config."""
    from mdd_tpu_torch import cli
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.ops.dropout_cuda import fused_dropout_kernel
    from mdd_tpu_torch.ops.lstm_cuda import lstm_bwd_kernel, lstm_fwd_kernel
    from mdd_tpu_torch.utils.config import load_config

    cfg = load_config(conf)
    cfg.exp_name, cfg.num_epoches = "smoke_fused", FUSED_EPOCHS
    vocab = Vocab.from_units_file(cfg.vocab_file)
    loaders = [cli._build_loader(cfg, vocab, *paths, train=train)
               for paths, train in (
                   ((cfg.train_scp_path, cfg.train_lab_path,
                     cfg.train_trans_path), True),
                   ((cfg.valid_scp_path, cfg.valid_lab_path,
                     cfg.valid_trans_path), False))]
    trainer = cli.build_trainer(cfg, vocab, "cuda", use_fused_dropout=True)
    lines = []
    kernels = (fused_dropout_kernel, lstm_fwd_kernel, lstm_bwd_kernel)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    trainer.fit(*loaders, num_epochs=FUSED_EPOCHS, print_every=1,
                checkpoint_dir=cfg.checkpoint_dir, exp_name=cfg.exp_name,
                log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    drops, fwd, bwd = (k.launches for k in kernels)
    steps = -(-TRAIN_UTTS // BATCH) * FUSED_EPOCHS
    forwards = steps + -(-DEV_UTTS // BATCH) * FUSED_EPOCHS
    losses = step_losses(lines)            # the first epoch's steps
    epochs = [float(v) for l in lines for v in
              re.findall(r"Train done, total_loss: (\S+?),", l)]
    for line in lines:
        if "done" in line:
            log(f"[train-fused]   {line}")
    log(f"[train-fused] {FUSED_EPOCHS} epochs of {TRAIN_UTTS} utterances at "
        f"B={BATCH} with use_fused_dropout in {wall:.1f} s; first epoch's "
        f"step losses {losses[0]:.4f} -> {losses[-1]:.4f}, epoch losses "
        f"{epochs}; fused_dropout launches {drops} over {steps} train "
        f"steps, lstm_fwd {fwd} over {forwards} forwards, lstm_bwd {bwd}")
    if (len(losses) * FUSED_EPOCHS != steps or len(epochs) != FUSED_EPOCHS
            or not all(math.isfinite(v) for v in losses + epochs)):
        raise AssertionError(f"losses missing or not finite: {losses}, "
                             f"{epochs}")
    if not (losses[-1] < losses[0] and epochs[-1] < epochs[0]):
        raise AssertionError(f"the loss did not fall: {losses}, {epochs}")
    if drops != 12 * steps or bwd != 4 * steps or fwd != 4 * forwards:
        raise AssertionError(
            f"{drops} dropout / {fwd} lstm_fwd / {bwd} lstm_bwd launches for "
            f"{steps} train steps and {forwards} forwards: a site or a layer "
            "bypassed its kernel")
    meta = json.loads((Path(cfg.checkpoint_dir) / cfg.exp_name
                       / "best.meta.json").read_text())
    if meta["model_config"].get("use_fused_dropout") is not True:
        raise AssertionError("best.meta.json does not carry "
                             "use_fused_dropout")
    compare_dropout_steps(torch, cfg, vocab, card)
    return {"fused_dropout": drops, "lstm_fwd": fwd, "lstm_bwd": bwd}


def compare_dropout_steps(torch, cfg, vocab, card: str) -> None:
    """Train steps at B=64 from the epoch's `latest`, with fused and with
    plain dropout in turns (plain, fused, fused, plain): each pass's median
    step time, and the device time of 3 profiled steps of each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mdd_tpu_torch import cli
    from mdd_tpu_torch.data.dataset import pad_batch_to

    trainers = {}
    for name, fused in (("plain", False), ("fused", True)):
        tr = cli.build_trainer(cfg, vocab, "cuda", use_fused_dropout=fused)
        tr.restore(cfg.checkpoint_dir, cfg.exp_name, "latest")
        trainers[name] = tr
    loader = cli._build_loader(cfg, vocab, cfg.train_scp_path,
                               cfg.train_lab_path, cfg.train_trans_path,
                               train=True)
    batches = [pad_batch_to(b, BATCH) for b in loader]
    acc = torch.zeros(4, device="cuda")
    medians = {"plain": [], "fused": []}
    for name in ("plain", "fused", "fused", "plain"):
        tr, secs = trainers[name], []
        for padded, valid in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            acc = tr.train_step(tr.batch_arrays(padded, valid), acc)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        medians[name].append(statistics.median(secs) * 1e3)
    busy = {}
    for name, tr in trainers.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for padded, valid in batches[:3]:
                acc = tr.train_step(tr.batch_arrays(padded, valid), acc)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        busy[name] = (sum(e.self_device_time_total for e in events) / 3e3,
                      sum(e.count for e in events) // 3)
        if name == "fused":
            for e in events:
                if "dropout_kernel" in e.key:
                    log(f"[train-fused]   {e.self_device_time_total / 3e3:.3f}"
                        f" ms a step in {e.count // 3} launches of "
                        f"{e.key[:70]}")
    log(f"[train-fused] step time at B={BATCH}, median of {len(batches)} "
        f"steps, passes in turn: plain dropout {medians['plain'][0]:.2f} / "
        f"{medians['plain'][1]:.2f} ms, fused {medians['fused'][0]:.2f} / "
        f"{medians['fused'][1]:.2f} ms; device time a step (3 profiled): "
        f"plain {busy['plain'][0]:.2f} ms in {busy['plain'][1]} ops, fused "
        f"{busy['fused'][0]:.2f} ms in {busy['fused'][1]} ops ({card})")


def phase_train_bf16(torch, train, dev, card: str) -> dict:
    """One epoch of the flagship recipe in bfloat16 with use_fused_dropout
    through the entry points `train` uses, its step time, then one step at
    bench.py's cell; -> the launch counts of the epoch."""
    from mdd_tpu_torch import cli
    from mdd_tpu_torch.data.dataset import pad_batch_to
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.ops.dropout_cuda import fused_dropout_kernel
    from mdd_tpu_torch.ops.lstm_cuda import lstm_bwd_kernel, lstm_fwd_kernel
    from mdd_tpu_torch.utils.config import load_config

    cfg = load_config(write_train_yaml(train, dev, 1, "bfloat16"))
    cfg.exp_name = "smoke_bf16"
    vocab = Vocab.from_units_file(cfg.vocab_file)
    loaders = [cli._build_loader(cfg, vocab, *paths, train=is_train)
               for paths, is_train in (
                   ((cfg.train_scp_path, cfg.train_lab_path,
                     cfg.train_trans_path), True),
                   ((cfg.valid_scp_path, cfg.valid_lab_path,
                     cfg.valid_trans_path), False))]
    trainer = cli.build_trainer(cfg, vocab, "cuda", use_fused_dropout=True)
    if trainer.model.dtype != torch.bfloat16:
        raise AssertionError("compute_dtype bfloat16 did not reach the model")
    kernels = (fused_dropout_kernel, lstm_fwd_kernel, lstm_bwd_kernel)
    for k in kernels:
        k.launches = 0
    lines = []
    t0 = time.perf_counter()
    trainer.fit(*loaders, num_epochs=1, print_every=1,
                checkpoint_dir=cfg.checkpoint_dir, exp_name=cfg.exp_name,
                log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    drops, fwd, bwd = (k.launches for k in kernels)
    steps = -(-TRAIN_UTTS // BATCH)
    forwards = steps + -(-DEV_UTTS // BATCH)
    losses = step_losses(lines)
    dev_line = next(l for l in lines if "Valid done" in l)
    log(f"[train-bf16] 1 epoch of {TRAIN_UTTS} utterances at B={BATCH}, "
        f"compute_dtype bfloat16, use_fused_dropout, in {wall:.1f} s: step "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f}; {dev_line}; "
        f"fused_dropout launches {drops} over {steps} train steps, lstm_fwd "
        f"{fwd} over {forwards} forwards, lstm_bwd {bwd}")
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses missing or not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the bfloat16 loss did not fall: {losses}")
    if drops != 12 * steps or bwd != 4 * steps or fwd != 4 * forwards:
        raise AssertionError(
            f"{drops} dropout / {fwd} lstm_fwd / {bwd} lstm_bwd launches for "
            f"{steps} train steps and {forwards} forwards: a site or a layer "
            "bypassed its kernel")
    # the step time at B=64, one pass over the corpus from the epoch's state
    loader = cli._build_loader(cfg, vocab, cfg.train_scp_path,
                               cfg.train_lab_path, cfg.train_trans_path,
                               train=True)
    acc = torch.zeros(4, device="cuda")
    secs = []
    for padded, valid in (pad_batch_to(b, BATCH) for b in loader):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = trainer.train_step(trainer.batch_arrays(padded, valid), acc)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    log(f"[train-bf16] step time at B={BATCH}: median "
        f"{statistics.median(secs) * 1e3:.2f} ms over {len(secs)} steps "
        f"(min {min(secs) * 1e3:.2f}, max {max(secs) * 1e3:.2f}) ({card})")
    bench_cell_step(torch, trainer.model_cfg, card)
    return {"fused_dropout": drops, "lstm_fwd": fwd, "lstm_bwd": bwd}


def bench_cell_step(torch, model_cfg, card: str) -> None:
    """Trainer steps of the full-width model at bench.py's cell (B=512 x
    160 spliced input frames, T'=80, 48 canonical phones, bfloat16, the
    kernels and fused dropout) on seeded random batches: the first step's
    loss finite and one lstm_bwd count a layer, then the step time."""
    from mdd_tpu_torch.ops.lstm_cuda import lstm_bwd_kernel
    from mdd_tpu_torch.train.loop import Trainer

    b, frames, labels = 512, 160, 48
    tr = Trainer(model_cfg, device="cuda", device_frontend=False)
    g = torch.Generator().manual_seed(SEED + 8)
    n_class = model_cfg.num_class
    arrays = (torch.randn((b, frames, model_cfg.input_dim), generator=g),
              torch.ones(b),
              torch.randint(2, n_class, (b, labels), generator=g),
              torch.full((b,), labels),
              torch.randint(2, n_class, (b, labels), generator=g),
              torch.full((b,), labels), torch.ones(b, dtype=torch.bool))
    arrays = tuple(a.cuda() for a in arrays)
    plan = lstm_bwd_kernel.plan(model_cfg.output_frames(frames), b,
                                model_cfg.rnn_hidden_size, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    before = lstm_bwd_kernel.launches
    acc = tr.train_step(arrays, torch.zeros(4, device="cuda"))
    torch.cuda.synchronize()
    made = lstm_bwd_kernel.launches - before
    loss = acc[0].item()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        acc = tr.train_step(arrays, acc)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    log(f"[train-bf16] bench.py's cell, B={b} x {frames} frames (T'="
        f"{model_cfg.output_frames(frames)}), {labels} canonical phones, "
        f"bfloat16: first step loss {loss:.4f}; lstm_bwd counts {made} for "
        f"{model_cfg.rnn_layers} layers, its recurrence in "
        f"{plan['launches']} launch(es) of {plan['chunk_rows']} rows; step "
        f"time {' / '.join(f'{v * 1e3:.1f}' for v in secs)} ms; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB "
        f"({card})")
    if not math.isfinite(loss) or loss >= 1e29:
        raise AssertionError(f"bench-cell step loss {loss}")
    if made != model_cfg.rnn_layers:
        raise AssertionError(f"{made} lstm_bwd counts for "
                             f"{model_cfg.rnn_layers} layers")


def write_eval_yaml(conf: str, name: str, split: tuple, lm: str) -> str:
    """The train YAML with the `smoke_fused` experiment, `split` as test
    split, and beam + LM decoding."""
    fields = {
        "exp_name": "smoke_fused", "test_scp_path": split[0],
        "test_lab_path": split[1], "test_trans_path": split[2],
        "decode_type": "Beam", "beam_width": 10, "lm_alpha": 0.5,
        "lm_path": lm}
    lines = [l for l in Path(conf).read_text().splitlines()
             if l.split(":")[0] not in fields]
    path = WORK / f"{name}.yaml"
    path.write_text("\n".join(lines) + "\n" + "".join(
        f"{k}: {json.dumps(v)}\n" for k, v in fields.items()))
    return str(path)


def parse_report(text: str) -> dict:
    """The all-languages block of format_mdd_report."""
    block = text.split(" mandarin ")[0]
    grab = lambda pat: re.search(pat, block).groups()
    total, parts = map(int, grab(r"total :  (\d+) (\d+)"))
    out = {"errors": int(grab(r"total_error: (\d+)")[0]),
           "tokens": int(grab(r"total_phoneme: (\d+)")[0]),
           "per": float(grab(r"Phoneme error rate on test set: (\S+)")[0]),
           "total": total, "parts": parts}
    for key in ("TA", "FR", "FA", "TR"):
        out[key] = int(grab(rf"{key} :  (\d+)")[0])
    out["f1"] = float(grab(r"F1 score : (\S+)")[0])
    out["utts"] = int(re.search(r"time used for decode (\d+) sentences",
                                text).group(1))
    if not all(math.isfinite(v) for v in out.values()):
        raise AssertionError(f"report holds a value that is not finite: {out}")
    return out


def phase_evaluate(torch, conf: str, train: tuple, dev: tuple,
                   card: str) -> tuple:
    """The evaluation path; -> (lstm_fwd launches, the YAML)."""
    from mdd_tpu_torch import cli
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.decode.arpa import ArpaBigramLM
    from mdd_tpu_torch.decode.beam import BeamSearchDecoder
    from mdd_tpu_torch.evals.evaluate import EvalSession
    from mdd_tpu_torch.evals.wer import read_trn
    from mdd_tpu_torch.ops.lstm_cuda import lstm_fwd_kernel
    from mdd_tpu_torch.utils.config import load_config

    lm = str(WORK / "lm.arpa")
    log("[evaluate] " + run_cli(["train-lm", "--phn-text", train[1],
                                 "--out", lm]).strip())
    yaml_path = write_eval_yaml(conf, "eval_dev", dev, lm)
    kinds = (("beam", []), ("beam_no_lm", ["--lm-alpha", "0"]),
             ("greedy", ["--decode-type", "Greedy"]))
    dumps = {k: WORK / f"dump_{k}" for k, _ in kinds}
    lstm_fwd_kernel.launches = 0
    reports, wall = {}, {}
    for kind, flags in kinds:
        t0 = time.perf_counter()
        text = run_cli(["evaluate", "--conf", yaml_path, "--device", "cuda",
                        "--dump-dir", str(dumps[kind])] + flags)
        wall[kind] = time.perf_counter() - t0
        reports[kind] = parse_report(text)
    launches = lstm_fwd_kernel.launches
    forwards = len(kinds) * -(-DEV_UTTS // BATCH)
    result = run_cli(["mdd-result", "--ref", str(dumps["beam"] / "transcribe.log"),
                      "--human", str(dumps["beam"] / "human_seq.log"),
                      "--hyp", str(dumps["beam"] / "decode_seq.log"),
                      "--detail-dir", str(WORK / "detail")])
    wer = re.search(r"%WER (\S+) \[ (\d+) / (\d+), (\d+) ins, (\d+) del, "
                    r"(\d+) sub \]", result)
    recall = float(re.search(r"Recall: (\S+)", result).group(1))
    canon = sum(len(v) for v in read_trn(
        str(dumps["beam"] / "transcribe.log")).values())
    beam, greedy = reports["beam"], reports["greedy"]
    for kind, r in reports.items():
        log(f"[evaluate] {kind}: PER {r['per']:.4f} ({r['errors']} / "
            f"{r['tokens']}), TA {r['TA']} FR {r['FR']} FA {r['FA']} TR "
            f"{r['TR']} over {r['total']} canonical phones, F1 {r['f1']:.2f}; "
            f"{r['utts']} utterances in {wall[kind]:.2f} s, set-up included "
            f"({card})")
    log(f"[evaluate] mdd-result on the beam + LM dumps: {wer.group(0)}; recall "
        f"{recall:.4f}; lstm_fwd launches {launches} over {forwards} "
        "forwards")
    for r in reports.values():
        if (r["utts"] != DEV_UTTS or r["total"] != canon
                or r["parts"] != r["TA"] + r["FR"] + r["FA"] + r["TR"]
                or r["parts"] < r["total"] or r["tokens"] <= 0):
            raise AssertionError(f"report does not add up: {r}, {canon} "
                                 "canonical phones in the dump")
    if (int(wer.group(2)), int(wer.group(3))) != (beam["errors"],
                                                  beam["tokens"]):
        raise AssertionError("mdd-result's PER is not evaluate's: "
                             f"{wer.group(0)} vs {beam}")
    if not math.isfinite(recall) or launches != 4 * forwards:
        raise AssertionError(f"{launches} lstm_fwd launches for {forwards} "
                             "forwards, or recall not finite")
    for kind in ("beam", "beam_no_lm"):
        if abs(reports[kind]["per"] - greedy["per"]) > PER_GAP:
            raise AssertionError(
                f"{kind} PER {reports[kind]['per']} and greedy PER "
                f"{greedy['per']} are over {PER_GAP} apart")

    # one batch of this model's log-probs: device beam vs host beam
    cfg = load_config(yaml_path)
    vocab = Vocab.from_units_file(cfg.vocab_file)
    state, model_cfg = cli._load_best(cfg, None)
    session = EvalSession(
        model_cfg, state, vocab, decode_type="Beam", beam_width=10,
        lm_path=lm, lm_alpha=0.5, device="cuda", device_frontend=True,
        left_ctx=cfg.left_ctx, right_ctx=cfg.right_ctx,
        n_skip_frame=cfg.n_skip_frame, n_downsample=cfg.n_downsample)
    batch = next(iter(cli._build_loader(cfg, vocab, *dev, train=False)))
    log_probs, frames = session._forward(*session.stage_batch(batch)[1])
    lp = log_probs.transpose(0, 1)
    on_card = session.beam.decode_log(lp, frames.tolist())
    on_cpu = session.beam.decode_log(lp.cpu(), frames.tolist())

    class TotalLM(ArpaBigramLM):
        """bi_prob for every unit: a word the LM never saw ("err" is in
        the inventory, not in the corpus) gets the -1e30 that dense_matrix
        gives the device beam, where the host beam would raise."""

        def bi_prob(self, w1: str, w2: str) -> float:
            known = all(w in self.unigram for w in (w1 or self.start,
                                                    w2 or self.end))
            return super().bi_prob(w1, w2) if known else -1e30

    host = BeamSearchDecoder(vocab.index2word, beam_width=10,
                             lm=TotalLM(lm), lm_alpha=0.5)
    t0 = time.perf_counter()
    want = host.decode(torch.exp(lp).double().cpu().numpy(), frames.tolist())
    host_s = time.perf_counter() - t0
    share = sum(a == b for a, b in zip(on_card, want)) / len(want)
    same_cpu = sum(a == b for a, b in zip(on_card, on_cpu)) / len(want)
    log(f"[evaluate] device beam vs host beam on {len(want)} utterances of "
        f"the model's log-probs (T' up to {int(frames.max())}): "
        f"{100 * share:.1f}% identical (bar {100 * BEAM_MATCH:.0f}%); the "
        f"same search on the CPU: {100 * same_cpu:.1f}% identical; host "
        f"beam {host_s:.1f} s")
    if share < BEAM_MATCH or same_cpu < BEAM_MATCH:
        raise AssertionError("the device beam disagrees with the host beam")
    return launches, yaml_path


def phase_profile_evaluate(torch, conf: str, train: tuple, card: str) -> None:
    """Throughput and device busy share of evaluate_model, and the beam
    alone."""
    from torch.profiler import ProfilerActivity, profile

    from mdd_tpu_torch import cli
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.decode.beam_jit import BatchedBeamDecoder
    from mdd_tpu_torch.evals.evaluate import EvalSession, evaluate_model
    from mdd_tpu_torch.utils.config import load_config

    lm = str(WORK / "lm.arpa")
    cfg = load_config(write_eval_yaml(conf, "eval_train", train, lm))
    vocab = Vocab.from_units_file(cfg.vocab_file)
    state, model_cfg = cli._load_best(cfg, None)
    quiet = lambda *_: None
    for kind in ("Beam", "Greedy"):
        session = EvalSession(
            model_cfg, state, vocab, decode_type=kind, beam_width=10,
            lm_path=lm, lm_alpha=0.5, device="cuda", device_frontend=True,
            left_ctx=cfg.left_ctx, right_ctx=cfg.right_ctx,
            n_skip_frame=cfg.n_skip_frame, n_downsample=cfg.n_downsample)
        rates = []
        for _ in range(2):
            loader = cli._build_loader(cfg, vocab, *train, train=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = evaluate_model(session, loader, log=quiet)
            torch.cuda.synchronize()
            rates.append(rep.n_utts / (time.perf_counter() - t0))
        log(f"[profile-evaluate] evaluate_model, {kind}, {rep.n_utts} "
            f"utterances in batches of {BATCH}: {rates[0]:.1f} then "
            f"{rates[1]:.1f} utterances per second; PER {rep.per:.2f} "
            f"({card})")
        if kind == "Beam":
            loader = cli._build_loader(cfg, vocab, *train, train=False)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                evaluate_model(session, loader, log=quiet)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            report_profile(prof, wall_us, "profile-evaluate",
                           f"one beam pass over {rep.n_utts} utterances "
                           "(profiler on)", card)

    # the beam alone at the evaluation shape
    t_out, n_class, width = 110, len(UNITS) + 2, 10
    g = torch.Generator().manual_seed(SEED + 5)
    logits = torch.randn((BATCH, t_out, n_class), generator=g)
    logits[:, :, 0] += 1.5
    lp = torch.log_softmax(logits, dim=-1).cuda()
    beam = BatchedBeamDecoder(vocab.index2word, beam_width=width,
                              device="cuda")
    lengths = [t_out] * BATCH
    beam.decode_log(lp, lengths)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        beam.decode_log(lp, lengths)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        beam.decode_log(lp, lengths)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ms = statistics.median(walls)
    log(f"[timing] device beam, B={BATCH} T'={t_out} K={width} C={n_class}: "
        f"{ms:.2f} ms a batch (median of 3; {min(walls):.2f}-"
        f"{max(walls):.2f}), {ms / t_out:.4f} ms a frame, "
        f"{BATCH / ms * 1e3:.0f} utterances per second ({card})")
    report_profile(prof, wall_us, "timing", "one beam batch (profiler on)",
                   card)



def phase_timing_dropout(torch, card: str) -> dict:
    """fused_dropout at the 3 sites of a train step, float32 and bfloat16
    (ops/dropout_time.py): a call (CUDA events over back-to-back calls,
    inputs rotating past L2) and the kernel's device time (torch.profiler),
    each the mean of two turns, beside the bound, the plain version and
    F.dropout; -> {site: {dtype: numbers}}."""
    from mdd_tpu_torch.ops.dropout_cuda import (
        SITES,
        bound_ms,
        fused_dropout_kernel,
    )
    from mdd_tpu_torch.ops.dropout_time import time_site

    out = {}
    for name, shape in SITES.items():
        n = math.prod(shape)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            times = time_site(name, dt, {"fused_dropout": fused_dropout_kernel},
                              50, plain_iters=3)
            (calls, kern, equal), (lib_calls, lib_kern, _) = (
                times["fused_dropout"], times["F.dropout"])
            if not equal:
                raise AssertionError(f"fused_dropout {dtype} at {name} "
                                     "differs from its plain version")
            bnd, bound_by = bound_ms(n, dt)
            entry = {"ms": statistics.mean(calls),
                     "kernel_ms": statistics.mean(kern),
                     "plain_ms": times["plain"][0][0], "bound_ms": bnd,
                     "bound_by": bound_by,
                     "library_ms": statistics.mean(lib_calls),
                     "library_kernel_ms": statistics.mean(lib_kern)}
            out.setdefault(name, {})[dtype] = entry
            log(f"[timing] fused_dropout {dtype} {name} {tuple(shape)} "
                f"({n / 1e6:.1f} M elements): a call "
                f"{' / '.join(f'{v:.4f}' for v in calls)} ms, kernel "
                f"{' / '.join(f'{v:.4f}' for v in kern)} ms "
                f"({100 * bnd / entry['kernel_ms']:.0f}% of its bound "
                f"{bnd:.4f} ms, {bound_by}); plain fused_dropout_reference "
                f"{entry['plain_ms']:.2f} ms; F.dropout a call "
                f"{' / '.join(f'{v:.4f}' for v in lib_calls)} ms, kernel "
                f"{' / '.join(f'{v:.4f}' for v in lib_kern)} ms ({card})")
            torch.cuda.empty_cache()
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "mdd_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repo (mdd_tpu_torch/ "
              "missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 means float32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = smi

    phase_build()
    worst = phase_kernel(torch)
    worst_bwd = phase_kernel_bwd(torch)
    cfg, meta, state = phase_model(torch)
    files = write_serving_files(cfg, meta, state)
    launches, engine = phase_serve(files, card)
    phase_profile(torch, engine, files, card)
    train = write_corpus("train", TRAIN_UTTS, SEED + 2)
    dev = write_corpus("dev", DEV_UTTS, SEED + 3)
    phase_model_grad(torch, cfg, state, dev)
    train_fwd, train_bwd, conf = phase_train(torch, train, dev)
    phase_step_time(torch, conf, card)
    timing, timing_bwd = phase_timing(torch, card)
    dropout_err = phase_kernel_dropout(torch)
    fused = phase_train_fused(torch, conf, card)
    bf16 = phase_train_bf16(torch, train, dev, card)
    eval_fwd, _ = phase_evaluate(torch, conf, train, dev, card)
    phase_profile_evaluate(torch, conf, train, card)
    dropout_timing = phase_timing_dropout(torch, card)
    shutil.rmtree(WORK, ignore_errors=True)

    by_batch = {str(b): {k: v for k, v in timing[b].items()
                         if k != "timing_err"} for b in FWD_TIMING_BATCHES}
    kernels = [{
        "name": "lstm_fwd",
        "route": "cuda",
        "source": "mdd_tpu_torch/csrc/lstm_fwd.cu",
        "replaces": "mdd_tpu/ops/lstm_pallas.py:61",
        "launches": (launches + train_fwd + fused["lstm_fwd"]
                     + bf16["lstm_fwd"] + eval_fwd),
        "launches_by_path": {"serve": launches, "train": train_fwd,
                             "train-fused": fused["lstm_fwd"],
                             "train-bf16": bf16["lstm_fwd"],
                             "evaluate": eval_fwd},
        "max_abs_err": max(worst["float32"],
                           *(timing[b]["timing_err"] for b in timing)),
        "shape": f"T'=80 B=16 H={H} float32",
        **by_batch["16"],
        "by_batch": by_batch,
    }, {
        "name": "lstm_bwd",
        "route": "cuda",
        "source": "mdd_tpu_torch/csrc/lstm_bwd.cu",
        "replaces": "mdd_tpu/ops/lstm_pallas.py:141",
        "launches": train_bwd + fused["lstm_bwd"] + bf16["lstm_bwd"],
        "launches_by_path": {"train": train_bwd,
                             "train-fused": fused["lstm_bwd"],
                             "train-bf16": bf16["lstm_bwd"]},
        "max_abs_err": worst_bwd["float32_abs"],
        "shape": f"T'=80 B={BATCH} H={H} float32",
        **timing_bwd[BATCH],
        "by_batch": {str(b): timing_bwd[b] for b in BWD_TIMING_BATCHES},
    }, {
        "name": "fused_dropout",
        "route": "cuda",
        "source": "mdd_tpu_torch/csrc/dropout.cu",
        "replaces": "mdd_tpu/ops/dropout_pallas.py:53",
        "launches": fused["fused_dropout"] + bf16["fused_dropout"],
        "launches_by_path": {"train-fused": fused["fused_dropout"],
                             "train-bf16": bf16["fused_dropout"]},
        "max_abs_err": dropout_err,
        "shape": "conv0 site 64x32x220x122 float32",
        **dropout_timing["conv0"]["float32"],
        "by_site": dropout_timing,
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
