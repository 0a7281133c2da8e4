"""The train step's greedy WER counts as one kernel launch.

Counterpart of mdd_tpu/ops/wer.py's `greedy_wer_counts` (the CTC collapse
and `batched_edit_distance`, which mdd_tpu compiles into its train step as
a lax.scan): on a CUDA tensor `greedy_wer` launches `csrc/wer.cu` (see the
notes there) or raises; on a CPU tensor it runs ops/wer.greedy_wer_counts,
the plain version, which loops over the padded columns.  Both give the
same integers: the tests and chip_smoke.py hold the kernel to it exactly.
"""

from __future__ import annotations

import ctypes

import torch

from mdd_tpu_torch.ops.build import KernelBinding
from mdd_tpu_torch.ops.wer import greedy_wer_counts

#: the longest target row the kernel takes: L + 1 DP cells in one warp's
#: registers, at most 32 a lane
MAX_TARGET_LEN = 1023
#: H100 SXM (NVIDIA's data sheet): memory rate, and the 32-bit integer rate
#: (64 a clock and SM, a quarter of the float32 67 TFLOP/s figure)
PEAK_BYTES_S = 3.35e12
PEAK_INT_OPS_S = 67e12 / 4
#: integer operations a DP cell and kept token: the compare with the
#: target, two adds, two mins, the subtract and add of j, the prefix-min
OPS_PER_CELL = 8


def bound_ms(ids, frames, targets, target_sizes) -> tuple:
    """(least ms, "bytes" or "operations") for these inputs: each row's own
    frames of ids, the targets and the three (B,) inputs read once, the
    distances and counts written once; OPS_PER_CELL a cell for each kept
    token (what this data needs, not the padded width)."""
    b, t = ids.shape
    n = frames.clamp(0, t)
    read = (n.sum().item() * 8 + targets.numel() * 8 + b * (8 + 8 + 1))
    kept = _kept_counts(ids, n)
    cells = (kept * (targets.shape[1] + 1)).sum().item()
    by_bytes = (read + b * 8 + 16) / PEAK_BYTES_S * 1e3
    by_ops = cells * OPS_PER_CELL / PEAK_INT_OPS_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _kept_counts(ids, n, blank: int = 0):
    t = ids.shape[1]
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    tvalid = torch.arange(t, device=ids.device)[None] < n[:, None]
    return (tvalid & (ids != blank) & (ids != prev)).sum(dim=1)


def _check(ids, frames, targets, target_sizes, valid) -> None:
    """Raises for what the kernel does not take; the device last, so that
    every other refusal shows on CPU tensors too."""
    for name, x, dtype, dim in (("ids", ids, torch.int64, 2),
                                ("frames", frames, torch.int64, 1),
                                ("targets", targets, torch.int64, 2),
                                ("target_sizes", target_sizes, torch.int64, 1),
                                ("valid", valid, torch.bool, 1)):
        if x.device != ids.device:
            raise ValueError(f"{name} lies on {x.device}, ids on {ids.device}")
        if x.dtype != dtype:
            raise TypeError(f"the WER kernel takes {name} as {dtype}, got "
                            f"{x.dtype}")
        if x.dim() != dim:
            raise ValueError(f"{name} must be {dim}-D, got {tuple(x.shape)}")
    b = ids.shape[0]
    if b < 1:
        raise ValueError("the WER kernel takes at least one row")
    if targets.shape[0] != b or any(x.shape != (b,) for x in
                                    (frames, target_sizes, valid)):
        raise ValueError("ids, frames, targets, target_sizes and valid must "
                         f"share the batch size {b}")
    if targets.shape[1] > MAX_TARGET_LEN:
        raise ValueError(f"the WER kernel takes targets of at most "
                         f"{MAX_TARGET_LEN} columns (L + 1 cells in one "
                         f"warp), got {targets.shape[1]}")
    for name, x in (("frames", frames), ("target_sizes", target_sizes),
                    ("valid", valid)):
        if not x.is_contiguous():
            raise ValueError(f"the WER kernel reads {name} as contiguous "
                             f"memory; pass {name}.contiguous()")
    if ids.device.type != "cuda":
        raise ValueError("the WER kernel takes CUDA tensors, got ids on "
                         f"{ids.device}")


class GreedyWerKernel(KernelBinding):
    """`mdd_greedy_wer` of csrc/wer.cu: -> ((B,) distances, (2,) counts)."""

    source, entry = "wer.cu", "mdd_greedy_wer"
    argtypes = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_void_p)

    def __call__(self, ids, frames, targets, target_sizes, valid,
                 blank: int = 0):
        _check(ids, frames, targets, target_sizes, valid)
        b, t = ids.shape
        dist = torch.empty(b, dtype=torch.int64, device=ids.device)
        counts = torch.zeros(2, dtype=torch.int64, device=ids.device)
        self._launch(ids.device, ids.data_ptr(), ids.stride(0), ids.stride(1),
                     frames.data_ptr(), targets.data_ptr(), targets.stride(0),
                     targets.stride(1), target_sizes.data_ptr(),
                     valid.data_ptr(), b, t, targets.shape[1], blank,
                     dist.data_ptr(), counts.data_ptr())
        return dist, counts


#: the process's binding; chip_smoke.py reads and resets its counter
greedy_wer_kernel = GreedyWerKernel()


def greedy_wer(ids, frames, targets, target_sizes, valid, blank: int = 0):
    """-> (errors, tokens) int64 device scalars over the valid rows, as
    ops/wer.greedy_wer_counts: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if ids.device.type == "cpu":
        return greedy_wer_counts(ids, frames, targets, target_sizes, valid,
                                 blank)
    _, counts = greedy_wer_kernel(ids, frames.long(), targets.long(),
                                  target_sizes.long(), valid.bool(), blank)
    return counts[0], counts[1]
