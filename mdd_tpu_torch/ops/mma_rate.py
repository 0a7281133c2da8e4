"""What the card's warp-level tensor-core op (`mma.sync`) and its FMA pipe
sustain with nothing else in the loop: the yardstick for the products inside
`csrc/lstm_bwd.cu`.

    python -m mdd_tpu_torch.ops.mma_rate

Builds `csrc/mma_rate.cu` and prints, for `mma.sync` in TF32 (m16n8k8,
m16n8k4) and bfloat16 (m16n8k16) and for float32 FMAs, the TFLOP/s with 8
independent accumulators a warp and with 1 (a fully dependent chain), at 8
and 16 warps an SM.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from mdd_tpu_torch.ops import build

ITERS = 20000
#: name, mode of `mdd_mma_rate`, float operations of one such op of a warp
CASES = (("mma.sync m16n8k8 tf32", 0, 2 * 16 * 8 * 8),
         ("mma.sync m16n8k4 tf32", 2, 2 * 16 * 8 * 4),
         ("mma.sync m16n8k16 bf16", 1, 2 * 16 * 8 * 16),
         ("fmaf, 4 a thread", 3, 2 * 4 * 32))


class MmaRate(build.KernelBinding):
    source, entry = "mma_rate.cu", "mdd_mma_rate"
    argtypes = (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 4

    def tflops(self, mode: int, ops: int, accs: int, blocks_per_sm: int):
        dev = torch.device("cuda")
        blocks = blocks_per_sm * torch.cuda.get_device_properties(
            dev).multi_processor_count
        out = torch.empty(blocks * 256, device=dev)
        ms = (ctypes.c_float * 1)()
        self._launch(dev, out.data_ptr(), ctypes.addressof(ms), mode, accs,
                     blocks, ITERS)
        return blocks * 8 * ITERS * accs * ops / ms[0] / 1e9


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("mma_rate: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    rate = MmaRate()
    for name, mode, ops in CASES:
        for accs in (8, 1):
            cells = ", ".join(
                f"{rate.tflops(mode, ops, accs, per_sm):7.1f} TFLOP/s at "
                f"{8 * per_sm} warps an SM" for per_sm in (1, 2))
            print(f"[mma-rate] {name:<24s} {accs} accumulator(s) a warp: "
                  f"{cells}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
