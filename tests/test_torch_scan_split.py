"""The arithmetic of csrc/lstm_scan.cu that the CPU can hold to account,
in its plain PyTorch versions (ops/lstm_cuda): the exact three-part
bfloat16 split of a float32 (`bf16_split3`, the kernels' `split3`) that
runs the float32-dgates products on bfloat16 tensor cores, and the order
in which dW_hh is summed (`lstm_scan_dw_reference`: every step's rounded
product at once, then the ordered bfloat16 carry)."""

import numpy as np
import pytest
import torch

from mdd_tpu_torch.ops import lstm_cuda


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.float().view(torch.int32)


def _from_bits(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


#: the exponent field of 2^-110, the least magnitude the split is exact at
#: (below it lo falls under bfloat16's subnormal grid)
MIN_EXACT_EXPONENT = 127 - 110


def _split_cases() -> dict:
    rng = np.random.default_rng(0)
    signs = rng.choice([-1.0, 1.0], 512)
    high = rng.integers(MIN_EXACT_EXPONENT << 7, 0x7f00, 512,
                        dtype=np.uint32) << 16
    return {
        "zeros": [0.0, -0.0],
        "powers of two": [s * 2.0 ** k for k in range(-99, 100, 3)
                          for s in (1.0, -1.0)],
        # low halves at, just under and just over a bfloat16 tie, and the
        # largest remainder: a rounding split would carry into hi here
        "near bfloat16 ties": _from_bits(np.concatenate(
            [high | low for low in (0x8000, 0x7fff, 0x8001, 0xffff, 0x0001)])),
        "1e-30 to 1e30": signs * np.logspace(-30, 30, 512),
        "seeded normal": rng.standard_normal(4096) * 0.05,
        "every significand bit set": _from_bits(
            (np.arange(MIN_EXACT_EXPONENT, 255, dtype=np.uint32) << 23)
            | 0x007fffff),
    }


SPLIT_CASES = _split_cases()


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_bf16_split3_is_exact(name):
    """hi + mid + lo == x bit for bit, summed in float32 in any order; hi
    is x cut to bfloat16 (not rounded), each part a bfloat16 value, each
    at most 2^-7 of the one before; -0 splits into three -0."""
    x = torch.from_numpy(np.asarray(SPLIT_CASES[name], dtype=np.float32))
    hi, mid, lo = lstm_cuda.bf16_split3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    h, m, lw = hi.float(), mid.float(), lo.float()
    for total in ((h + m) + lw, h + (m + lw), (lw + m) + h):
        assert torch.equal(_bits(total), _bits(x))
    assert torch.equal(_bits(h), _bits(x) & -65536)
    assert (m.abs() <= x.abs() * 2.0 ** -7).all()
    assert (lw.abs() <= x.abs() * 2.0 ** -14).all()
    negative_zero = _bits(x) == -2 ** 31
    for part in (h, m, lw):
        assert (_bits(part)[negative_zero] == -2 ** 31).all()


def test_bf16_split3_products_match_a_float64_product():
    """A float32 times a bfloat16 as the kernels take it: three products,
    each exact in float32, summed small terms first, equal to the float64
    product within float32's rounding of two sums; and a K = 384 dot of
    three float32 passes (lo, mid, hi) within the float32 summation bound
    of the float64 dot."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((64, 384)) * np.exp(
        rng.uniform(-20, 20, (64, 1)))).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(384).astype(np.float32)
                         ).bfloat16().float()
    parts = [p.float() for p in lstm_cuda.bf16_split3(x)]   # hi, mid, lo
    for p in parts:
        assert torch.equal((p * w).double(), p.double() * w.double())
    exact = x.double() * w.double()
    got = (parts[2] * w + parts[1] * w) + parts[0] * w
    eps = 2.0 ** -24
    assert ((got.double() - exact).abs() <= 2 * eps * exact.abs()).all()
    dot = sum((p * w).sum(dim=1) for p in reversed(parts))
    bound = 3 * 384 * eps * (x.double().abs() * w.double().abs()).sum(dim=1)
    assert ((dot.double() - exact.sum(dim=1)).abs() <= bound).all()


@pytest.mark.parametrize("t,b,h", [(1, 3, 8), (2, 3, 8), (5, 4, 16),
                                   (7, 1, 8), (9, 5, 24)])
def test_parallel_dw_order_equals_the_serial_carry(t, b, h):
    """dW_hh as csrc/lstm_scan.cu sums it, every step's product rounded to
    bfloat16 at once and then the ordered carry from t = T-1 down, equal
    bit for bit to lstm_scan_bwd_reference's serial sum (the transpose's
    own order), on the reference's own float32 dgates; and those dgates
    rounded are its dx_proj."""
    g = torch.Generator().manual_seed(t * 100 + b)
    x_proj = (torch.randn((t, 2, b, 4 * h), generator=g) * 0.5).bfloat16()
    w_hh = ((torch.rand((2, h, 4 * h), generator=g) * 2 - 1)
            / h ** 0.5).bfloat16()
    hs, cs = lstm_cuda.lstm_scan_fwd_reference(x_proj, w_hh)
    dhs = torch.randn((t, 2, b, h), generator=g).bfloat16()
    dxp, dw, dgates = lstm_cuda.lstm_scan_bwd_reference(
        x_proj, w_hh, hs, cs, dhs, return_dgates=True)
    assert dgates.dtype == torch.float32 and dgates.shape == x_proj.shape
    assert torch.equal(dgates.bfloat16(), dxp)
    got = lstm_cuda.lstm_scan_dw_reference(hs, dgates)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), dw.view(torch.int16))
    assert torch.equal(lstm_cuda.lstm_scan_bwd_reference(
        x_proj, w_hh, hs, cs, dhs)[1].view(torch.int16), dw.view(torch.int16))


def test_scan_bindings_are_the_scan_source():
    """The scan contract's bindings load csrc/lstm_scan.cu (the backward
    with its dW_hh step scratch: 12 pointers, then T, B, H, the dtype and
    the parts), the Pallas contract's keep their own sources; nothing is
    built on the CPU."""
    fwd, bwd = lstm_cuda.lstm_scan_fwd_kernel, lstm_cuda.lstm_scan_bwd_kernel
    assert fwd.source == bwd.source == "lstm_scan.cu"
    assert (fwd.entry, bwd.entry) == ("mdd_lstm_scan_fwd", "mdd_lstm_scan_bwd")
    assert len(fwd.argtypes) == 5 + 4 and len(bwd.argtypes) == 12 + 5
    assert lstm_cuda.lstm_fwd_kernel.source == "lstm_fwd.cu"
    assert lstm_cuda.lstm_bwd_kernel.source == "lstm_bwd.cu"
    assert fwd._lib is None and bwd._lib is None
