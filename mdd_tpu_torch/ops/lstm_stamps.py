"""Where a step of an LSTM recurrence spends its time on the card.

    python -m mdd_tpu_torch.ops.lstm_stamps --kernel fwd|bwd [--batch 64 16]
        [--steps 80] [--time 1 4 16 64] [--source lstm_fwd_variant.cu]

Builds `csrc/lstm_fwd.cu` or `csrc/lstm_bwd.cu` a second time with
`-DMDD_LSTM_FWD_STAMPS` / `-DMDD_LSTM_BWD_STAMPS` (a separate library in
`_build/`; the normal build carries no stamps), in which thread 0 of block
0 adds `clock64()` differences to one counter per phase of a step of the
recurrence.  Runs the kernel at H=384 in float32 through the package's own
wrapper and prints each phase's share of the stamped cycles.  The stamps
are one block's view: a phase that ends in a barrier includes that block's
wait for the others.  `--time` first times the normal build by CUDA events
at those batches.  `--source` measures another file with the same entry
points in place of the package's (a variant under trial, kept anywhere
outside `csrc/`; it includes the headers of `csrc/`).  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from mdd_tpu_torch.ops import lstm_cuda

MAX_PHASES = 8
KERNELS = {"fwd": lstm_cuda.lstm_fwd_kernel, "bwd": lstm_cuda.lstm_bwd_kernel}


def _inputs(batch: int, steps: int, hidden: int, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    x_proj = (torch.randn((steps, 2, batch, 4 * hidden), generator=g) * 0.5
              ).to("cuda", dtype)
    w_hh = ((torch.rand((2, hidden, 4 * hidden), generator=g) * 2 - 1)
            / hidden ** 0.5).to("cuda", dtype)
    dhs = torch.randn((steps, 2, batch, hidden), generator=g).cuda()
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
    """-> a call of `kernel` on seeded inputs, and the recurrence's steps
    (the backward's chain runs T-1 of them)."""
    x_proj, w_hh, hs, cs, dhs = _inputs(batch, steps, hidden, dtype)
    if name == "fwd":
        return lambda: kernel(x_proj, w_hh), steps
    return lambda: kernel(x_proj, w_hh, hs, cs, dhs), max(steps - 1, 1)


def _event_ms(fn, iters: int) -> float:
    for _ in range(2):
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


def _stamp_fn(lib, name: str, what: str):
    fn = getattr(lib, f"mdd_lstm_{name}_{what}")
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
                iters: int, dtype=torch.float32) -> None:
    """The normal build's time by CUDA events."""
    with torch.no_grad():
        fn, chain = _runner(name, kernel, batch, steps, hidden, dtype)
        ms = _event_ms(fn, iters)
    plan = (kernel.plan(batch, hidden, dtype) if name == "fwd"
            else kernel.plan(steps, batch, hidden, dtype))
    print(f"[stamps] lstm_{name} ({Path(kernel.source).name}) "
          f"{str(dtype)[6:]} B={batch} T'={steps} H={hidden}: {ms:.4f} ms, "
          f"{ms * 1e3 / chain:.2f} us a step (normal build); plan {plan}")


def stamp_kernel(name: str, source: str | None, batch: int, steps: int,
                 hidden: int, iters: int) -> None:
    kernel = _binding(name, source,
                      (f"-DMDD_LSTM_{name.upper()}_STAMPS",))
    with torch.no_grad():
        fn, chain = _runner(name, kernel, batch, steps, hidden)
        fn()
        torch.cuda.synchronize()
        lib = kernel.library()
        names = _stamp_fn(lib, name, "stamp_names")().decode().split(",")
        _read_stamps(lib, name)                    # zero the counters
        ms = _event_ms(fn, iters)
    # _event_ms ran 2 warm-up calls beside the timed ones
    cycles = _read_stamps(lib, name)[:len(names)]
    total = sum(cycles)
    per_step = (iters + 2) * chain
    print(f"[stamps] lstm_{name} float32 B={batch} T'={steps} H={hidden}: "
          f"stamped build {ms:.4f} ms; block 0 stamped "
          f"{total / per_step:.0f} cycles a step")
    for phase, c in zip(names, cycles):
        print(f"[stamps]   {phase:<28s} {100.0 * c / total:5.1f}%  "
              f"{c / per_step:9.0f} cycles a step")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), required=True)
    ap.add_argument("--batch", type=int, nargs="*", default=[64, 16],
                    help="batches at which to stamp a step")
    ap.add_argument("--time", type=int, nargs="*", default=[],
                    help="batches at which to time the normal build first")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--hidden", type=int, default=384)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32", help="of what --time measures")
    ap.add_argument("--source", help="a .cu file to measure in place of "
                    "the kernel's own source")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lstm_stamps: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    kernel = _binding(args.kernel, args.source)
    for batch in args.time:
        time_kernel(args.kernel, kernel, batch, args.steps, args.hidden, 50,
                    getattr(torch, args.dtype))
    for batch in args.batch:
        stamp_kernel(args.kernel, args.source, batch, args.steps, args.hidden,
                     args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
