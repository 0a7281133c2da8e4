"""Where a step of an LSTM recurrence spends its time on the card.

    python -m mdd_tpu_torch.ops.lstm_stamps --kernel fwd|bwd [--batch 64 16]
        [--steps 80] [--time 1 4 16 64] [--source lstm_fwd_variant.cu]
    python -m mdd_tpu_torch.ops.lstm_stamps --kernel scan-fwd|scan-bwd
        --steps 48 --batch 64 512 --time 64 512 1x7 [--parent DIR]

Builds the kernel's source a second time with its stamp flag
(`STAMPS` below: `-DMDD_LSTM_FWD_STAMPS` for `csrc/lstm_fwd.cu`,
`-DMDD_LSTM_SCAN_STAMPS` for `csrc/lstm_scan.cu`, ...; a
separate library in `_build/`; the normal build carries no stamps), in
which thread 0 of block 0 adds `clock64()` differences to one counter per
phase of a step of the recurrence.  Runs the kernel at H=384 through the
package's own wrapper (the Pallas contract in float32, the scan contract
in bfloat16, its only dtype) and prints each phase's share of the stamped
cycles.  The stamps are one block's view: a phase that ends in a barrier
includes that block's wait for the others.  `--time` first times the
normal build by CUDA events at those shapes (B at `--steps`, or BxT) and
prints the call's plan and, for a backward, each of its launches one by
one (`run_parts`); for the scan kernels also the device time of a call,
as replays of a CUDA graph of ten calls (`graph_ms`: the wrapper's host
work left out).  `--parent DIR` times the scan kernels of another tree
(`DIR/mdd_tpu_torch/csrc/`, say a `git archive` of the parent commit
unpacked into the gitignored `_scratch/old/`) the same way, in turns with
this one: parent, tree, tree, parent.  That tree's kernels are bound by
what its sources hold (`scan_bindings`).  `--source` measures another
file with the same entry points in place of the package's (a variant
under trial, kept anywhere outside `csrc/`; it includes the headers of
`csrc/`).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from mdd_tpu_torch.ops import lstm_cuda

MAX_PHASES = 8
KERNELS = {"fwd": lstm_cuda.lstm_fwd_kernel, "bwd": lstm_cuda.lstm_bwd_kernel,
           "scan-fwd": lstm_cuda.lstm_scan_fwd_kernel,
           "scan-bwd": lstm_cuda.lstm_scan_bwd_kernel}
#: kernel -> (the stamp build's -D flag, the prefix of its stamp entries)
STAMPS = {"fwd": ("MDD_LSTM_FWD_STAMPS", "mdd_lstm_fwd"),
          "bwd": ("MDD_LSTM_BWD_STAMPS", "mdd_lstm_bwd"),
          "scan-fwd": ("MDD_LSTM_SCAN_STAMPS", "mdd_lstm_scan_fwd"),
          "scan-bwd": ("MDD_LSTM_SCAN_STAMPS", "mdd_lstm_scan_bwd")}


def parse_shape(text: str, steps: int) -> tuple:
    """"64" -> (64, steps); "1x7" -> (1, 7): (B, T)."""
    b, _, t = text.partition("x")
    return int(b), int(t) if t else steps


def dtype_of(name: str, asked=torch.float32) -> torch.dtype:
    """The dtype a kernel runs in here: the scan kernels take bfloat16
    only."""
    return torch.bfloat16 if name.startswith("scan") else asked


def _inputs(name: str, batch: int, steps: int, hidden: int,
            dtype=torch.float32):
    """Seeded (x_proj, w_hh, hs, cs, dhs) for kernel `name`: hs and cs from
    its contract's forward kernel, dhs float32 (bfloat16 values under the
    scan contract, the cotangent's dtype there)."""
    g = torch.Generator().manual_seed(0)
    x_proj = (torch.randn((steps, 2, batch, 4 * hidden), generator=g) * 0.5
              ).to("cuda", dtype)
    w_hh = ((torch.rand((2, hidden, 4 * hidden), generator=g) * 2 - 1)
            / hidden ** 0.5).to("cuda", dtype)
    dhs = torch.randn((steps, 2, batch, hidden), generator=g).cuda()
    if name.startswith("scan"):
        hs, cs = lstm_cuda.lstm_scan_fwd_kernel(x_proj, w_hh)
        return x_proj, w_hh, hs, cs, dhs.bfloat16().float()
    hs, cs = lstm_cuda.lstm_fwd_kernel(x_proj, w_hh)
    return x_proj, w_hh, hs, cs, dhs


def _binding(name: str, source: str | None, extra_flags: tuple = ()):
    """A binding of the kernel `name`, of the file `source` if given."""
    kernel = type(KERNELS[name])(extra_flags=extra_flags)
    if source:
        kernel.source = str(Path(source).resolve())
    return kernel


def _runner(name: str, kernel, batch: int, steps: int, hidden: int,
            dtype=torch.float32):
    """-> a call of `kernel` on seeded inputs, the recurrence's steps (the
    backward's chain runs T-1 of them) and, for a backward, a function that
    launches the parts its argument names into one set of buffers."""
    args = _inputs(name, batch, steps, hidden, dtype)
    if name.endswith("fwd"):
        return lambda: kernel(*args[:2]), steps, None
    buffers = kernel.buffers(args[0])
    return (lambda: kernel(*args), max(steps - 1, 1),
            lambda parts: kernel.run_parts(*args, buffers, parts))


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of a call over `iters` back-to-back calls, by CUDA events."""
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


def graph_ms(fn, iters: int = 20, calls: int = 10) -> float:
    """The device time of one fn() by CUDA events over replays of a CUDA
    graph of `calls` calls: the wrapper's host work (checks, allocations,
    the ctypes call) is left out, so that a kernel shorter than it is
    timed, not the host."""
    fn()                                    # builds and loads the kernel
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return event_ms(graph.replay, iters) / calls


def in_turns(fns: dict, order: tuple, iters: int) -> dict:
    """name -> the device times of fns[name] (graph_ms), taken in
    `order`."""
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(graph_ms(fns[k], iters))
    return times


class _InlineScanFwd(lstm_cuda.LstmFwdKernel):
    """The scan forward of a tree that built it from lstm_fwd.cu (its
    kScan instance, the plan of `LstmFwdKernel`)."""

    entry, scan = "mdd_lstm_scan_fwd", True


class _InlineScanBwd(lstm_cuda.LstmBwdKernel):
    """The scan backward of a tree that built it from lstm_bwd.cu: five
    buffers, no dW_hh step scratch (one block walked every step of its
    dW_hh tile)."""

    entry, scan = "mdd_lstm_scan_bwd", True

    def buffers(self, x_proj) -> tuple:
        """(dx_proj, dW_hh, z, dgates, exchange)"""
        t, _, b, four_h = x_proj.shape
        h, dev = four_h // 4, x_proj.device
        with torch.cuda.device(dev):
            plan = self.plan(t, b, h, x_proj.dtype)
        f32 = dict(dtype=torch.float32, device=dev)
        return (torch.empty_like(x_proj),
                torch.empty((2, h, four_h), dtype=x_proj.dtype, device=dev),
                torch.empty((t, 2, b, four_h), **f32),
                torch.empty((t, 2, b, four_h), **f32),
                torch.empty(plan["exchange_elems"], **f32))


#: where a tree may hold its scan kernels, newest first: per kernel (the
#: source in csrc/, the binding that takes its entry point's arguments)
SCAN_LAYOUTS = (
    ((("lstm_scan.cu", lstm_cuda.LstmScanFwdKernel),
      ("lstm_scan.cu", lstm_cuda.LstmScanBwdKernel))),
    ((("lstm_fwd.cu", _InlineScanFwd), ("lstm_bwd.cu", _InlineScanBwd))),
)


def entry_params(text: str, entry: str) -> int | None:
    """The number of parameters of C function `entry` in source `text`, or
    None where the text defines no such function."""
    head = text.split(f"int {entry}(")
    if len(head) < 2:
        return None
    return head[1].split(")")[0].count(",") + 1


def scan_bindings(tree) -> tuple | None:
    """(forward, backward) bindings of the scan kernels of another tree
    (`tree` holds `mdd_tpu_torch/csrc/`), called as lstm_cuda's scan
    bindings are, or None where it has none this package can call: the
    first of SCAN_LAYOUTS whose sources define both entry points with the
    binding's argument list (the stream last).  Nothing is built."""
    csrc = Path(tree) / "mdd_tpu_torch" / "csrc"
    for layout in SCAN_LAYOUTS:
        kernels = []
        for source, cls in layout:
            path = csrc / source
            kernel = cls()
            want = len(kernel.argtypes) + 1
            if (not path.exists()
                    or entry_params(path.read_text(), kernel.entry) != want):
                break
            kernel.source = str(path.resolve())
            kernels.append(kernel)
        else:
            return tuple(kernels)
    return None


def scan_turns(name: str, b: int, t: int, parent, hidden: int = 384,
               iters: int = 20, kernel=None) -> dict:
    """The times of the scan kernel `name` ("scan-fwd" or "scan-bwd";
    `kernel`, the package's binding by default) at B=b, T=t in bfloat16,
    in turns with the same kernel of tree `parent` (parent, tree, tree,
    parent) where `scan_bindings` finds one: each turn a call's time by
    CUDA events over back-to-back calls (the wrapper's host work
    included) and its device time (graph_ms); -> {"ms": device times,
    "call_ms": call times, "parent_ms", "parent_call_ms": the parent's, or
    None}."""
    old = scan_bindings(parent) if parent else None
    fns = {"tree": _runner(name, kernel or KERNELS[name], b, t, hidden,
                           torch.bfloat16)[0]}
    if old:
        fns["parent"] = _runner(name, old[name == "scan-bwd"], b, t, hidden,
                                torch.bfloat16)[0]
    device = {k: [] for k in fns}
    call = {k: [] for k in fns}
    order = ("parent", "tree", "tree", "parent") if old else ("tree", "tree")
    with torch.no_grad():
        for k in order:
            call[k].append(event_ms(fns[k], iters))
            device[k].append(graph_ms(fns[k], iters))
    return {"ms": device["tree"], "call_ms": call["tree"],
            "parent_ms": device.get("parent"),
            "parent_call_ms": call.get("parent")}


def _stamp_fn(lib, name: str, what: str):
    fn = getattr(lib, f"{STAMPS[name][1]}_{what}")
    if what == "read_stamps":
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
    else:
        fn.restype = ctypes.c_char_p
    return fn


def _read_stamps(lib, name: str) -> list:
    out = (ctypes.c_longlong * MAX_PHASES)()
    err = _stamp_fn(lib, name, "read_stamps")(out, MAX_PHASES)
    if err != 0:
        raise RuntimeError("reading the stamps failed: "
                           + lib.mdd_cuda_error_string(err).decode())
    return list(out)


def time_kernel(name: str, kernel, batch: int, steps: int, hidden: int,
                iters: int, dtype=torch.float32, parent=None) -> None:
    """The normal build's time by CUDA events, its plan and a backward's
    launches one by one; for a scan kernel also its device time, in
    turns with tree `parent`'s (`scan_turns`)."""
    with torch.no_grad():
        fn, chain, parts = _runner(name, kernel, batch, steps, hidden, dtype)
        ms = event_ms(fn, iters)
        by_part = {} if parts is None else {
            part: event_ms(lambda bit=bit: parts(bit), iters)
            for part, bit in (("pre-activation product", kernel.Z_PRODUCT),
                              ("recurrence", kernel.CHAIN),
                              ("dW_hh", kernel.DW_PRODUCT))}
    plan = (kernel.plan(batch, hidden, dtype) if name.endswith("fwd")
            else kernel.plan(steps, batch, hidden, dtype))
    print(f"[stamps] lstm_{name} ({Path(kernel.source).name}) "
          f"{str(dtype)[6:]} B={batch} T'={steps} H={hidden}: {ms:.4f} ms, "
          f"{ms * 1e3 / chain:.2f} us a step (normal build); plan {plan}")
    for part, part_ms in by_part.items():
        print(f"[stamps]   {part:<28s} {part_ms:.4f} ms")
    if name.startswith("scan"):
        got = scan_turns(name, batch, steps, parent, hidden, kernel=kernel)
        print(f"[stamps]   device time (graph replays) {got['ms']} ms, a "
              f"call (events) {got['call_ms']} ms"
              + (f"; {Path(parent).name}'s {got['parent_ms']} ms, a call "
                 f"{got['parent_call_ms']} ms (in turns: parent, tree, tree, "
                 f"parent)" if got["parent_ms"] else
                 f"; {parent} holds no scan kernels this package can call"
                 if parent else ""))


def stamp_kernel(name: str, source: str | None, batch: int, steps: int,
                 hidden: int, iters: int) -> None:
    kernel = _binding(name, source, (f"-D{STAMPS[name][0]}",))
    dtype = dtype_of(name)
    with torch.no_grad():
        fn, chain, _ = _runner(name, kernel, batch, steps, hidden, dtype)
        fn()
        torch.cuda.synchronize()
        lib = kernel.library()
        names = _stamp_fn(lib, name, "stamp_names")().decode().split(",")
        _read_stamps(lib, name)                    # zero the counters
        ms = event_ms(fn, iters)
    # event_ms ran 2 warm-up calls beside the timed ones; every launch of
    # a call (a batch past one launch runs as several) stamps its block 0
    cycles = _read_stamps(lib, name)[:len(names)]
    total = sum(cycles)
    plan = (kernel.plan(batch, hidden, dtype) if name.endswith("fwd")
            else kernel.plan(steps, batch, hidden, dtype))
    per_step = (iters + 2) * chain * plan["launches"]
    print(f"[stamps] lstm_{name} {str(dtype)[6:]} B={batch} T'={steps} "
          f"H={hidden}: "
          f"stamped build {ms:.4f} ms; block 0 stamped "
          f"{total / per_step:.0f} cycles a step of a launch; plan {plan}")
    for phase, c in zip(names, cycles):
        print(f"[stamps]   {phase:<28s} {100.0 * c / total:5.1f}%  "
              f"{c / per_step:9.0f} cycles a step")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), required=True)
    ap.add_argument("--batch", type=int, nargs="*", default=[64, 16],
                    help="batches at which to stamp a step")
    ap.add_argument("--time", nargs="*", default=[],
                    help="shapes (B at --steps, or BxT) at which to time "
                    "the normal build first")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--hidden", type=int, default=384)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32", help="of what --time measures "
                    "(the scan kernels run bfloat16 whatever is asked)")
    ap.add_argument("--source", help="a .cu file to measure in place of "
                    "the kernel's own source")
    ap.add_argument("--parent", help="a tree whose scan kernels --time "
                    "times in turns with this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lstm_stamps: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    kernel = _binding(args.kernel, args.source)
    for shape in args.time:
        time_kernel(args.kernel, kernel, *parse_shape(shape, args.steps),
                    args.hidden, 50,
                    dtype_of(args.kernel, getattr(torch, args.dtype)),
                    args.parent)
    for batch in args.batch:
        stamp_kernel(args.kernel, args.source, batch, args.steps, args.hidden,
                     args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
