"""Fused dropout: the mask is made from a seed inside one kernel and applied
there, on both passes.

Counterpart of mdd_tpu/ops/dropout_pallas.py:

  forward:   out = where(bits(seed) < threshold, x * (1 / keep), 0)
  backward:  dx  = where(bits(seed) < threshold, dy * (1 / keep), 0)

with keep = 1 - rate and threshold = min(round(keep * 2^32), 2^32 - 1), so
the only residual autograd keeps is the seed: no mask tensor and no random
bits in device memory.  The bits are Philox-4x32-10 over the flat element
index (element i takes word i & 3 of the block with counter (i >> 2, 0, 0)
and the seed's two halves as key); the product runs in float32 and is
rounded to x's dtype.  The mask pattern is not the TPU generator's; its
distribution is.

On a CUDA tensor `fused_dropout_apply` launches `csrc/dropout.cu` (see the
notes there) or raises; on a CPU tensor it runs
`fused_dropout_reference`, the same Philox in int64 tensor arithmetic,
which equals the kernel bit for bit: the tests and chip_smoke.py hold the
kernel to it exactly.  `FusedDropout` is the autograd Function (the custom
VJP of dropout_pallas), `fused_dropout` the entry point the model calls.
"""

from __future__ import annotations

import ctypes

import torch

from mdd_tpu_torch.ops.build import KernelBinding

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK32 = 0xFFFFFFFF
_MUL = (0xD2511F53, 0xCD9E8D57)      # Philox-4x32 multipliers
_BUMP = (0x9E3779B9, 0xBB67AE85)     # key increments per round
_ROUNDS = 10
SEED_HIGH = 2 ** 63 - 1              # seeds are drawn from [0, SEED_HIGH)

#: the dropout sites of one train step at B=64, T=220 model frames (T'=110),
#: where chip_smoke.py and ops/dropout_time.py time the kernel
SITES = {"conv0": (64, 32, 220, 122), "conv1": (64, 32, 110, 61),
         "bilstm": (110, 64, 768)}
#: H100 SXM (NVIDIA's data sheet): memory rate, and the integer rate: the
#: 67 TFLOP/s float32 figure counts an FMA as 2 operations at 128 a clock
#: and SM; the 32-bit integer pipes do 64 a clock and SM (CUDA C
#: Programming Guide, compute capability 9.0), a quarter of that
PEAK_BYTES_S = 3.35e12
PEAK_INT_OPS_S = 67e12 / 4
#: integer operations an element: per group of 4, ten Philox rounds of two
#: 32x32 -> 64-bit multiplies (one IMAD.WIDE.U32 each; the first round
#: has one, its other operand being 0) and two 3-input xors (LOP3), 39 in
#: all; per element the compare with the threshold and the select
OPS_PER_ELEMENT = 39 / 4 + 2


def bound_ms(n: int, dtype: torch.dtype) -> tuple:
    """(least ms, "bytes" or "operations") for dropout over n elements:
    x read once, out written once; OPS_PER_ELEMENT integer operations."""
    by_bytes = 2 * n * torch.finfo(dtype).bits / 8 / PEAK_BYTES_S * 1e3
    by_ops = n * OPS_PER_ELEMENT / PEAK_INT_OPS_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def keep_threshold(rate: float) -> int:
    """P(keep) = threshold / 2^32 over uniform 32-bit words."""
    return min(int(round((1.0 - rate) * 2.0 ** 32)), 2 ** 32 - 1)


def _mulhilo(m: int, b: torch.Tensor):
    """(high, low) 32-bit words of m * b for a 32-bit constant m and int64
    b in [0, 2^32).  The full product reaches 2^64, past a signed int64, so
    it is formed from the 16-bit halves of m; every intermediate stays
    non-negative and below 2^49."""
    p1 = (m >> 16) * b                       # < 2^48
    p0 = (m & 0xFFFF) * b                    # < 2^48
    low = ((p1 & 0xFFFF) << 16) + p0         # < 2^49
    return (p1 >> 16) + (low >> 32), low & _MASK32


def philox4x32_10(counter, key):
    """Philox-4x32-10 on int64 tensors holding 32-bit words: counter is 4
    tensors of one shape, key 2 tensors (or 0-dim); -> 4 tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(_ROUNDS):
        hi0, lo0 = _mulhilo(_MUL[0], c0)
        hi1, lo1 = _mulhilo(_MUL[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _BUMP[0]) & _MASK32
        k1 = (k1 + _BUMP[1]) & _MASK32
    return c0, c1, c2, c3


def dropout_bits(seed: torch.Tensor, n: int) -> torch.Tensor:
    """The n 32-bit words (as int64) the kernel draws for flat indices
    0..n-1 under `seed`, a 1-element int64 tensor; on seed's device."""
    groups = torch.arange(-(-n // 4), dtype=torch.int64, device=seed.device)
    s = seed.reshape(())
    zero = torch.zeros_like(groups)
    words = philox4x32_10(
        (groups & _MASK32, groups >> 32, zero, zero),
        (s & _MASK32, (s >> 32) & _MASK32))
    return torch.stack(words, dim=1).reshape(-1)[:n]


def _check_seed(x: torch.Tensor, seed: torch.Tensor) -> None:
    if (seed.dtype != torch.int64 or seed.numel() != 1
            or seed.device != x.device):
        raise ValueError("seed must be a 1-element int64 tensor on x's "
                         f"device, got {seed.dtype} {tuple(seed.shape)} on "
                         f"{seed.device} for x on {x.device}")


def _check_rate(rate: float) -> None:
    if not 0.0 < rate < 1.0:
        raise ValueError(f"rate must lie in (0, 1), got {rate}")


def fused_dropout_reference(x: torch.Tensor, seed: torch.Tensor,
                            rate: float) -> torch.Tensor:
    """The plain PyTorch version: what the kernel computes, bit for bit."""
    _check_rate(rate)
    _check_seed(x, seed)
    keep = dropout_bits(seed, x.numel()).reshape(x.shape) < keep_threshold(rate)
    inv_keep = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32,
                            device=x.device)
    scaled = (x.float() * inv_keep).to(x.dtype)
    return torch.where(keep, scaled, torch.zeros_like(scaled))


class FusedDropoutKernel(KernelBinding):
    """`mdd_fused_dropout` of csrc/dropout.cu: (x, seed, rate) -> out."""

    source, entry = "dropout.cu", "mdd_fused_dropout"
    argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_uint, ctypes.c_float,
                ctypes.c_int)

    def __call__(self, x: torch.Tensor, seed: torch.Tensor,
                 rate: float) -> torch.Tensor:
        if x.device.type != "cuda":
            raise ValueError("the dropout kernel takes a CUDA tensor, got "
                             f"one on {x.device}")
        if x.dtype not in _DTYPE_CODES:
            raise TypeError("the dropout kernel takes float32 or bfloat16, "
                            f"got {x.dtype}")
        _check_rate(rate)
        _check_seed(x, seed)
        if not x.is_contiguous():
            raise ValueError("the dropout kernel indexes flat contiguous "
                             "memory; pass x.contiguous()")
        if x.numel() == 0:
            raise ValueError("the dropout kernel takes at least one element")
        out = torch.empty_like(x)
        self._launch(x.device, x.data_ptr(), out.data_ptr(), seed.data_ptr(),
                     x.numel(), keep_threshold(rate), 1.0 / (1.0 - rate),
                     _DTYPE_CODES[x.dtype])
        return out


#: the process's binding; chip_smoke.py reads and resets its counter
fused_dropout_kernel = FusedDropoutKernel()


def fused_dropout_apply(x: torch.Tensor, seed: torch.Tensor,
                        rate: float) -> torch.Tensor:
    """Dropout of a contiguous x under `seed`: the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return fused_dropout_reference(x, seed, rate)
    return fused_dropout_kernel(x, seed, rate)


class FusedDropout(torch.autograd.Function):
    """fused_dropout_apply with its backward: the same op on dy under the
    same seed.  Saves the seed tensor and the rate, nothing else."""

    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.save_for_backward(seed)
        ctx.rate = rate
        return fused_dropout_apply(x.contiguous(), seed, rate)

    @staticmethod
    def backward(ctx, dy):
        (seed,) = ctx.saved_tensors
        # same seed, same flat order -> the forward's mask
        return fused_dropout_apply(dy.contiguous(), seed, ctx.rate), None, None


def fused_dropout(x: torch.Tensor, rate: float,
                  generator: torch.Generator | None) -> torch.Tensor:
    """Dropout with the mask made in the kernel (see the module docstring).

    One seed is drawn from `generator` per call, on x's device, so every
    site and every step gets its own mask and the host never waits for the
    draw."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    seed = torch.randint(0, SEED_HIGH, (1,), dtype=torch.int64,
                         generator=generator, device=x.device)
    return FusedDropout.apply(x, seed, rate)
