"""Where a step of the LSTM backward recurrence spends its time on the card.

    python -m mdd_tpu_torch.ops.lstm_bwd_stamps [--batch 64 16] [--steps 80]

Builds `csrc/lstm_bwd.cu` with `-DMDD_LSTM_BWD_STAMPS` (a separate library
in `_build/`; the normal build carries no stamps), in which thread 0 of
block 0 adds `clock64()` differences to one counter per phase of a step.
Runs the backward at H=384 in float32 through the package's own wrapper and
prints each phase's share of the stamped cycles, and the same share of the
recurrence kernel's time by CUDA events.  The stamps are one block's view:
a phase that ends in a barrier includes that block's wait for the others.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from mdd_tpu_torch.ops import build, lstm_cuda

STAMP_FLAG = "-DMDD_LSTM_BWD_STAMPS"
MAX_PHASES = 8


def _read_stamps(lib) -> list:
    out = (ctypes.c_longlong * MAX_PHASES)()
    lib.mdd_lstm_bwd_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mdd_lstm_bwd_read_stamps.restype = ctypes.c_int
    err = lib.mdd_lstm_bwd_read_stamps(out, MAX_PHASES)
    if err != 0:
        raise RuntimeError("reading the stamps failed: "
                           + lib.mdd_cuda_error_string(err).decode())
    return list(out)


def measure(batch: int, steps: int, hidden: int, iters: int) -> None:
    g = torch.Generator().manual_seed(0)
    x_proj = (torch.randn((steps, 2, batch, 4 * hidden), generator=g) * 0.5
              ).cuda()
    w_hh = ((torch.rand((2, hidden, 4 * hidden), generator=g) * 2 - 1)
            / hidden ** 0.5).cuda()
    dhs = torch.randn((steps, 2, batch, hidden), generator=g).cuda()
    kernel = lstm_cuda.lstm_bwd_kernel
    with torch.no_grad():
        hs, cs = lstm_cuda.lstm_fwd_kernel(x_proj, w_hh)
        for _ in range(2):
            kernel(x_proj, w_hh, hs, cs, dhs)
        torch.cuda.synchronize()
        lib = kernel.library()
        lib.mdd_lstm_bwd_stamp_names.restype = ctypes.c_char_p
        names = lib.mdd_lstm_bwd_stamp_names().decode().split(",")
        _read_stamps(lib)                      # zero the counters
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            kernel(x_proj, w_hh, hs, cs, dhs)
        end.record()
        torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    cycles = _read_stamps(lib)[:len(names)]
    total = sum(cycles)
    chain_steps = iters * max(steps - 1, 1)
    print(f"[stamps] float32 B={batch} T'={steps} H={hidden}: whole backward "
          f"(stamped build, every kernel of it) {ms:.4f} ms; block 0 stamped "
          f"{total / chain_steps:.0f} cycles a step")
    for name, c in zip(names, cycles):
        print(f"[stamps]   {name:<24s} {100.0 * c / total:5.1f}%  "
              f"{c / chain_steps:9.0f} cycles a step")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[64, 16])
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--hidden", type=int, default=384)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lstm_bwd_stamps: no CUDA device")
    build.NVCC_FLAGS = build.NVCC_FLAGS + (STAMP_FLAG,)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for batch in args.batch:
        measure(batch, args.steps, args.hidden, args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
