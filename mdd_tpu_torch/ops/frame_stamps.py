"""Where a frame of a frame-chain kernel spends its time: the beam, the
CTC loss's alpha and gradient chains, the train step's WER.

    python -m mdd_tpu_torch.ops.frame_stamps --kernel alpha|beam|beta_grad|wer
        [--batch 64] [--time 1 64 512x80] [--frames 110] [--iters 20]
        [--thread 0] [--source variant.cu] [--parent DIR]

Builds `csrc/ctc_beam.cu`, `csrc/ctc_loss.cu` or `csrc/wer.cu` a second
time with `-DMDD_CTC_BEAM_STAMPS` / `-DMDD_CTC_LOSS_STAMPS` /
`-DMDD_WER_STAMPS` (a separate library in `_build/`; the normal build
carries no stamps), in which one thread of block 0 (`--thread`, 0 by
default: the beam's first stay, the loss's slot 0 or first lane, the
WER's first lane) sums `clock64()` differences per phase of a frame in
registers, runs it through the package's wrapper and prints each phase's
share and its cycles a frame of row 0 (the beam: a kept frame; the WER: a
kept token, one step of its edit-distance chain).  The stamps are one
thread's view: a phase that ends in a barrier includes its wait for the
others.  `--time` first times the normal build by CUDA events at those
shapes (B, or BxT'), as replays of a CUDA graph of ten calls (the
wrapper's host work left out), and a call to a synchronize (with it),
beside its chain floor: a third build with `-D..._SKELETON`, the same
launch geometry and frame loop with its barriers, shuffles and
shared-memory round trips and none of the arithmetic.  `--parent DIR`
also times the kernel of another tree (`DIR/mdd_tpu_torch/csrc/`, say a
`git archive` of the parent commit unpacked into the gitignored
`_scratch/old/`) in turns with this one: parent, tree, tree, parent.
`--source` measures another file with the same entry points in place of
the package's (a variant under trial, kept outside `csrc/`).  The shapes
are the main path's: the beam at K=10 over C=43 classes without an LM,
the loss at L=40 and C=43, the WER at L=40 over ids of 43 classes laid
out as the train step's argmax(-1).transpose(0, 1).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from pathlib import Path

import time

import torch

from mdd_tpu_torch.ops import beam_cuda, ctc_cuda, wer_cuda
from mdd_tpu_torch.ops.build import KernelBinding
from mdd_tpu_torch.ops.lstm_stamps import event_ms, graph_ms, in_turns

MAX_PHASES = 8
CLASSES = 43
BEAM_WIDTH = 10
LABELS = 40
#: name -> (source in csrc/, binding class, the prefix of its -D flags,
#: the prefix of its stamp entry points)
KERNELS = {
    "alpha": ("ctc_loss.cu", ctc_cuda.CtcAlphaKernel, "MDD_CTC_LOSS",
              "mdd_ctc_alpha"),
    "beam": ("ctc_beam.cu", beam_cuda.CtcBeamKernel, "MDD_CTC_BEAM",
             "mdd_ctc_beam"),
    "beta_grad": ("ctc_loss.cu", ctc_cuda.CtcBetaGradKernel, "MDD_CTC_LOSS",
                  "mdd_ctc_loss"),
    "wer": ("wer.cu", wer_cuda.GreedyWerKernel, "MDD_WER", "mdd_wer"),
}


def parse_shape(text: str, frames: int) -> tuple:
    """"64" -> (64, frames); "512x80" -> (512, 80)."""
    b, _, t = text.partition("x")
    return int(b), int(t) if t else frames


def beam_inputs(b: int, t: int, seed: int = 0):
    """Seeded blank-boosted log-probs (B, T', 43), full lengths and no LM,
    on the card."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn((b, t, CLASSES), generator=g)
    logits[:, :, 0] += 1.5
    lp = torch.log_softmax(logits, -1).cuda()
    lengths = torch.full((b,), t, dtype=torch.int64, device="cuda")
    matrix = torch.zeros((CLASSES + 1, CLASSES + 1), device="cuda")
    return lp, lengths, matrix


def loss_inputs(b: int, t: int, seed: int = 0):
    """Seeded CTC inputs on the card: log-softmax of N(0, 4) logits (T', B,
    43), labels 1-42 of lengths 16-40, input lengths T'/2-T'."""
    g = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(torch.randn((t, b, CLASSES), generator=g) * 2, -1)
    labels = torch.randint(1, CLASSES, (b, LABELS), generator=g)
    label_lengths = torch.randint(16, LABELS + 1, (b,), generator=g)
    input_lengths = torch.randint(max(1, t // 2), t + 1, (b,), generator=g)
    return (lp.cuda(), input_lengths.cuda(), labels.cuda(),
            label_lengths.cuda())


def wer_inputs(b: int, t: int, seed: int = 0):
    """Seeded greedy-WER inputs on the card: ids over 43 classes (a third
    blank, 30% repeats of the frame before) laid out as the train step's
    argmax(-1).transpose(0, 1) (strided), frames T'/2-T', targets 1-42 of
    L=40 columns, sizes 16-40, every row valid."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, CLASSES, (t, b), generator=g)
    ids[torch.rand((t, b), generator=g) < 1 / 3] = 0
    repeat = torch.rand((t - 1, b), generator=g) < 0.3
    ids[1:] = torch.where(repeat, ids[:-1], ids[1:])
    frames = torch.randint(max(1, t // 2), t + 1, (b,), generator=g)
    targets = torch.randint(1, CLASSES, (b, LABELS), generator=g)
    sizes = torch.randint(16, LABELS + 1, (b,), generator=g)
    valid = torch.ones(b, dtype=torch.bool)
    return (ids.cuda().t(), frames.cuda(), targets.cuda(), sizes.cuda(),
            valid.cuda())


class _ParentWer(wer_cuda.GreedyWerKernel):
    """`mdd_greedy_wer` of a tree whose kernel adds its counts into a
    buffer the caller zeroed (two launches a call: the fill, the
    kernel)."""

    def __call__(self, ids, frames, targets, target_sizes, valid,
                 blank: int = 0):
        b, t = ids.shape
        dist = torch.empty(b, dtype=torch.int64, device=ids.device)
        counts = torch.zeros(2, dtype=torch.int64, device=ids.device)
        self._launch(ids.device, ids.data_ptr(), ids.stride(0), ids.stride(1),
                     frames.data_ptr(), targets.data_ptr(), targets.stride(0),
                     targets.stride(1), target_sizes.data_ptr(),
                     valid.data_ptr(), b, t, targets.shape[1], blank,
                     dist.data_ptr(), counts.data_ptr())
        return dist, counts


class _ParentBetaGrad(KernelBinding):
    """`mdd_ctc_beta_grad` of a tree whose entry point takes no weights
    scratch (the kernel that summed the classes on its frame chain)."""

    entry = "mdd_ctc_beta_grad"
    argtypes = ctc_cuda._ARGS + (ctypes.c_void_p,) * 4 + (
        ctypes.c_longlong,) * 2

    def __call__(self, log_probs, input_lengths, labels, label_lengths,
                 alphas, nll, g, blank: int = 0):
        grad = torch.empty_like(log_probs)
        self._launch(log_probs.device, *ctc_cuda._common(
            log_probs, input_lengths, labels, label_lengths, blank),
            alphas.data_ptr(), nll.data_ptr(), g.data_ptr(),
            grad.data_ptr(), grad.stride(0), grad.stride(1))
        return grad


def binding(name: str, source: str | None = None, extra: tuple = ()):
    """A binding of kernel `name` built with `extra` flags, of the file
    `source` if given.  A source whose `mdd_ctc_beta_grad` takes no
    weights scratch is bound with that older argument list; one whose WER
    kernel adds into caller-zeroed counts, with a wrapper that zeroes
    them."""
    cls = KERNELS[name][1]
    if source and name == "beta_grad":
        head = Path(source).read_text().split("int mdd_ctc_beta_grad(")[-1]
        if not re.search(r"float\*\s*weights", head.split(")")[0]):
            cls = _ParentBetaGrad
    if source and name == "wer" and "atomicAdd(counts" in Path(
            source).read_text():
        cls = _ParentWer
    kernel = cls(extra_flags=extra)
    if source:
        kernel.source = str(Path(source).resolve())
    return kernel


def parent_source(name: str, parent: str | Path) -> str:
    """The kernel's source in another tree (`parent` holds
    `mdd_tpu_torch/csrc/`)."""
    return str(Path(parent) / "mdd_tpu_torch" / "csrc" / KERNELS[name][0])


def runner(name: str, kernel, b: int, t: int, seed: int = 0):
    """-> (a call of `kernel` on seeded inputs at B=b, T'=t, the frames
    row 0 runs (the beam's kept frames, the loss's input length, the WER's
    kept tokens), the kernel's bound on these inputs: (least ms, "bytes"
    or "operations"))."""
    if name == "wer":
        args = wer_inputs(b, t, seed)
        kept = int(wer_cuda._kept_counts(args[0][:1], args[1][:1])[0])
        return (lambda: kernel(*args), max(kept, 1),
                wer_cuda.bound_ms(*args[:4]))
    if name == "beam":
        lp, lengths, matrix = beam_inputs(b, t, seed)
        frames = int(beam_cuda.kept_frames(lp[:1], lengths[:1], 0, 0.1)[0])
        return (lambda: kernel(lp, lengths, matrix, BEAM_WIDTH, 0, 0.1),
                max(frames, 1), beam_cuda.bound_ms(lp, lengths, matrix,
                                                   BEAM_WIDTH, 0, 0.1))
    args = loss_inputs(b, t, seed)
    if name == "alpha":
        return (lambda: kernel(*args), max(int(args[1][0]), 1),
                ctc_cuda.bound_ms(*args, kernel="ctc_alpha"))
    nll, alphas = ctc_cuda.ctc_alpha_kernel(*args)
    g = torch.ones(b, device="cuda")
    return (lambda: kernel(*args, alphas, nll, g), max(int(args[1][0]), 1),
            ctc_cuda.bound_ms(*args, kernel="ctc_beta_grad"))


def chain_floor_ms(name: str, b: int, t: int, iters: int = 20,
                   source: str | None = None) -> float:
    """The skeleton build's device time at (b, t) (graph_ms)."""
    kernel = binding(name, source, (f"-D{KERNELS[name][2]}_SKELETON",))
    with torch.no_grad():
        return graph_ms(runner(name, kernel, b, t)[0], iters)


def call_ms(fn, iters: int = 200) -> float:
    """Mean wall ms of fn() to a synchronize, the wrapper's host work
    included, after one warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _stamp_fns(lib, prefix: str):
    names = getattr(lib, f"{prefix}_stamp_names")
    names.restype = ctypes.c_char_p
    read = getattr(lib, f"{prefix}_read_stamps")
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    return names, read


def _read_stamps(lib, read) -> list:
    out = (ctypes.c_longlong * MAX_PHASES)()
    err = read(out, MAX_PHASES)
    if err != 0:
        raise RuntimeError("reading the stamps failed: "
                           + lib.mdd_cuda_error_string(err).decode())
    return list(out)


def time_kernel(name: str, source: str | None, parent: str | None, b: int,
                t: int, iters: int = 20) -> dict:
    """The normal build's device times (graph_ms; in turns with the parent
    tree's kernel: parent, tree, tree, parent), its chain floor and bound,
    printed; -> them."""
    fn, _, (least, by) = runner(name, binding(name, source), b, t)
    fns = {"tree": fn}
    if parent:
        fns["parent"] = runner(name, binding(name, parent_source(
            name, parent)), b, t)[0]
    with torch.no_grad():
        times = in_turns(fns, ("parent", "tree", "tree", "parent")
                         if parent else ("tree", "tree"), iters)
        calls = {k: call_ms(f) for k, f in fns.items()}
        floor = chain_floor_ms(name, b, t, iters, source)
    ms = min(times["tree"])
    line = (f"[frame_stamps] {name} B={b} T'={t}: {times['tree']} ms "
            f"({ms * 1e3 / t:.3f} us a frame); a call to a synchronize "
            f"{calls['tree']:.4f} ms; chain floor {floor:.4f} ms "
            f"({floor * 1e3 / t:.3f} us a frame); bound {least:.6f} ms "
            f"({by})")
    if parent:
        line += (f"; parent {times['parent']} ms "
                 f"({min(times['parent']) * 1e3 / t:.3f} us a frame; in "
                 f"turns), a call {calls['parent']:.4f} ms")
    print(line + f"; SM clock {sm_clock()}", flush=True)
    return {"ms": times["tree"], "parent_ms": times.get("parent"),
            "call_ms": calls["tree"], "parent_call_ms": calls.get("parent"),
            "chain_floor_ms": floor, "bound_ms": least, "bound_by": by,
            "us_per_frame": ms * 1e3 / t}


def stamp_kernel(name: str, source: str | None, b: int, t: int,
                 iters: int, thread: int = 0) -> None:
    _, _, prefix, entry = KERNELS[name]
    kernel = binding(name, source, (f"-D{prefix}_STAMPS",
                                    f"-DMDD_STAMP_THREAD={thread}"))
    with torch.no_grad():
        fn, frames, _ = runner(name, kernel, b, t)
        fn()
        torch.cuda.synchronize()
        lib = kernel.library()
        names_fn, read = _stamp_fns(lib, entry)
        names = names_fn().decode().split(",")
        _read_stamps(lib, read)                    # zero the counters
        ms = event_ms(fn, iters)
    cycles = _read_stamps(lib, read)[:len(names)]
    total = sum(cycles)
    per = (iters + 2) * frames   # event_ms ran 2 warm-up calls too
    print(f"[frame_stamps] {name} B={b} T'={t}: stamped build {ms:.4f} ms; "
          f"thread {thread} of block 0 stamped {total / per:.0f} cycles a "
          f"frame of row 0 "
          f"({frames} frames); SM clock {sm_clock()}")
    for phase, c in zip(names, cycles):
        print(f"[frame_stamps]   {phase:<32s} {100.0 * c / total:5.1f}%  "
              f"{c / per:9.0f} cycles a frame")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), required=True)
    ap.add_argument("--batch", nargs="*", default=["64"],
                    help="shapes (B or BxT') at which to stamp a frame")
    ap.add_argument("--time", nargs="*", default=[],
                    help="shapes at which to time the normal build and its "
                    "chain floor first")
    ap.add_argument("--frames", type=int, default=110)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--thread", type=int, default=0,
                    help="the thread of block 0 that stamps")
    ap.add_argument("--source", help="a .cu file to measure in place of "
                    "the kernel's own source")
    ap.add_argument("--parent", help="a tree whose kernel --time times in "
                    "turns with this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("frame_stamps: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for shape in args.time:
        time_kernel(args.kernel, args.source, args.parent,
                    *parse_shape(shape, args.frames))
    for shape in args.batch:
        stamp_kernel(args.kernel, args.source,
                     *parse_shape(shape, args.frames), args.iters,
                     args.thread)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
