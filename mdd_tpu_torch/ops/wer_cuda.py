"""The train step's greedy WER counts as one kernel launch.

Counterpart of mdd_tpu/ops/wer.py's `greedy_wer_counts` (the CTC collapse
and `batched_edit_distance`, which mdd_tpu compiles into its train step as
a lax.scan): on a CUDA tensor `greedy_wer` launches `csrc/wer.cu` (see the
notes there) or raises; on a CPU tensor it runs ops/wer.greedy_wer_counts,
the plain version, which loops over the padded columns.  Both give the
same integers: the tests and chip_smoke.py hold the kernel to it exactly.

The kernel runs the edit distance bit-parallel (Myers 1999, in Hyyro's
form for the global distance): `edit_distance_bits` and `greedy_wer_bits`
are a plain Python model of its recurrence, word by word, with the add's
carry and the shifts crossing words as the kernel's lanes pass them.
Nothing on the main path calls them; tests/test_torch_wer_bits.py holds
them to mdd_tpu's distances on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from mdd_tpu_torch.ops.build import KernelBinding
from mdd_tpu_torch.ops.wer import greedy_wer_counts

#: the longest target row the kernel takes: its rows in 16 words of 64
#: bits, one a lane of a warp
MAX_TARGET_LEN = 1023
#: H100 SXM (NVIDIA's data sheet): memory rate, and the 32-bit integer rate
#: (64 a clock and SM, a quarter of the float32 67 TFLOP/s figure)
PEAK_BYTES_S = 3.35e12
PEAK_INT_OPS_S = 67e12 / 4
#: bits a word of the kernel's bit-vectors: one word a lane, target rows
#: 1 .. 64 in lane 0's
WORD_BITS = 64
#: 32-bit integer operations a word and kept token: the recurrence's ~15
#: word operations (an add, a shift and logic) on 64-bit words, two each
OPS_PER_WORD = 30


def words_for(l: int, bits: int = WORD_BITS) -> int:
    """Words of the bit-vectors for targets of l columns (row j of the
    distance column in bit j - 1): 1 for l <= bits."""
    return max(1, -(-l // bits))


def bound_ms(ids, frames, targets, target_sizes) -> tuple:
    """(least ms, "bytes" or "operations") for these inputs: each row's own
    frames of ids, the targets and the three (B,) inputs read once, the
    distances and counts written once; OPS_PER_WORD a word of the
    bit-vectors for each kept token (what this data needs, not the padded
    width)."""
    b, t = ids.shape
    n = frames.clamp(0, t)
    read = (n.sum().item() * 8 + targets.numel() * 8 + b * (8 + 8 + 1))
    kept = _kept_counts(ids, n)
    words = kept.sum().item() * words_for(targets.shape[1])
    by_bytes = (read + b * 8 + 16) / PEAK_BYTES_S * 1e3
    by_ops = words * OPS_PER_WORD / PEAK_INT_OPS_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _kept_counts(ids, n, blank: int = 0):
    t = ids.shape[1]
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    tvalid = torch.arange(t, device=ids.device)[None] < n[:, None]
    return (tvalid & (ids != blank) & (ids != prev)).sum(dim=1)


def _bit_step(vp: list, vn: list, eq: list, bits: int) -> tuple:
    """One kept token on the words of VP, VN (the distance column's +1 and
    -1 vertical steps) and Eq (the rows whose target is the token), word 0
    holding rows 1 .. bits: the kernel's recurrence.  Each word adds
    (Eq & VP) + VP on its own; the carry into word k is bit k of
    (G + (G | P)) ^ (P & ~G) over the words' carry-outs G and all-ones
    sums P, the warp's carry-lookahead; the horizontal steps shift up one
    row, word k - 1's top bit into word k, and a +1 into row 1, so that
    row 0 counts the tokens so far."""
    full = (1 << bits) - 1
    n = len(vp)
    x = [e & v for e, v in zip(eq, vp)]
    add = [(a + v) & full for a, v in zip(x, vp)]
    gen = sum(int(add[k] < x[k]) << k for k in range(n))
    prop = sum(int(add[k] == full) << k for k in range(n))
    carry = (gen + (gen | prop)) ^ (prop & ~gen)
    add = [(add[k] + (carry >> k & 1)) & full for k in range(n)]
    xh = [(add[k] ^ vp[k]) | eq[k] for k in range(n)]
    xv = [eq[k] | vn[k] for k in range(n)]
    ph = [vn[k] | (~(xh[k] | vp[k]) & full) for k in range(n)]
    mh = [vp[k] & xh[k] for k in range(n)]
    top = bits - 1
    ph = [((ph[k] << 1) & full) | (1 if k == 0 else ph[k - 1] >> top)
          for k in range(n)]
    mh = [((mh[k] << 1) & full) | (0 if k == 0 else mh[k - 1] >> top)
          for k in range(n)]
    vp = [mh[k] | (~(xv[k] | ph[k]) & full) for k in range(n)]
    vn = [ph[k] & xv[k] for k in range(n)]
    return vp, vn


def edit_distance_bits(pred: list, targets: list, at: int,
                       bits: int = WORD_BITS) -> int:
    """Levenshtein distance of the token list `pred` to targets[:at], `at`
    clamped to [0, len(targets)] as the kernel clamps it, by the kernel's
    bit-parallel recurrence on words of `bits` bits (one word while
    len(targets) <= bits)."""
    l = len(targets)
    n = words_for(l, bits)
    full = (1 << bits) - 1
    vp, vn = [full] * n, [0] * n          # row j of column 0 is j
    for x in pred:
        eq = [0] * n
        for j, y in enumerate(targets):
            if y == x:
                eq[j // bits] |= 1 << (j % bits)
        vp, vn = _bit_step(vp, vn, eq, bits)
    at = min(max(at, 0), l)
    low = [((1 << min(max(at - k * bits, 0), bits)) - 1) for k in range(n)]
    return len(pred) + sum(bin(vp[k] & low[k]).count("1")
                           - bin(vn[k] & low[k]).count("1")
                           for k in range(n))


def greedy_wer_bits(ids, frames, targets, target_sizes, valid,
                    blank: int = 0, bits: int = WORD_BITS):
    """-> ((B,) distances, errors, tokens) as the kernel computes them, row
    by row in Python: the collapse over each row's own frames (frames
    clamped to [0, T]), then `edit_distance_bits`; errors sum the valid
    rows' distances, tokens their target sizes."""
    b, t = ids.shape
    dist = []
    for r in range(b):
        n = min(max(int(frames[r]), 0), t)
        row = [int(v) for v in ids[r, :n]]
        pred = [x for i, x in enumerate(row)
                if x != blank and x != (row[i - 1] if i else -1)]
        dist.append(edit_distance_bits(pred, [int(v) for v in targets[r]],
                                       int(target_sizes[r]), bits))
    keep = [bool(v) for v in valid]
    errors = sum(d for d, k in zip(dist, keep) if k)
    tokens = sum(int(s) for s, k in zip(target_sizes, keep) if k)
    return torch.tensor(dist, dtype=torch.int64), errors, tokens


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
                         f"{MAX_TARGET_LEN} columns (a word of "
                         f"{WORD_BITS} rows a lane of one warp), got "
                         f"{targets.shape[1]}")
    for name, x in (("frames", frames), ("target_sizes", target_sizes),
                    ("valid", valid)):
        if not x.is_contiguous():
            raise ValueError(f"the WER kernel reads {name} as contiguous "
                             f"memory; pass {name}.contiguous()")
    if ids.device.type != "cuda":
        raise ValueError("the WER kernel takes CUDA tensors, got ids on "
                         f"{ids.device}")


class GreedyWerKernel(KernelBinding):
    """`mdd_greedy_wer` of csrc/wer.cu: -> ((B,) distances, (2,) counts),
    one launch a call: the kernel writes every output, the counts too."""

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
        counts = torch.empty(2, dtype=torch.int64, device=ids.device)
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
