"""The scan contract of ops/lstm_cuda (`bilstm_scan_cuda`, the route of the
text BiLSTM with use_pallas_lstm in bfloat16) against mdd_tpu's
`ops.lstm.bilstm` and JAX's autodiff of it, on the CPU, where its
wrappers run the plain versions of the scan kernels.

Each case feeds the same numpy inputs (a row of zeroed inputs, as a row of
trans_lengths 0 gives the text encoder) and the same output cotangent to
`jax.vjp` of mdd_tpu's bilstm and to the port's autograd, in float32 and
in bfloat16.  mdd_tpu's side is jitted with XLA's excess precision off, so
that it rounds every op to its declared dtype as PyTorch does (see
tests/test_torch_bf16.py).  Held: the bfloat16 outputs within one
bfloat16 ulp; every gradient (x, both directions' W_ih, W_hh and biases)
to test_torch_bf16.py's rule at k = 0.1.  The Pallas contract's plain
versions (`bilstm_cuda`: c carried in float32, float32 cotangents) must
fail that rule on the same case, so the test tells the contracts apart.

    python -m pytest tests/test_torch_text_lstm.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdd_tpu.ops.lstm import bilstm as jax_bilstm
from mdd_tpu.ops.lstm import lstm_scan
from mdd_tpu_torch.ops import lstm_cuda
from mdd_tpu_torch.ops.lstm import bilstm as plain_bilstm
from test_torch_bf16 import DTYPES, K, NO_EXCESS_PRECISION, assert_bf16_close

NAMES = ("output", "x", "w_ih_fwd", "w_hh_fwd", "w_ih_bwd", "w_hh_bwd",
         "b_fwd", "b_bwd")
#: (T, B, D, H): one step and several, a batch of one and of three
CASES = [(1, 1, 8, 4), (1, 3, 16, 8), (5, 1, 8, 4), (5, 3, 12, 8),
         (12, 1, 16, 8), (12, 3, 16, 8)]


def _inputs(t, b, d, h, seed):
    """bilstm's arguments and an output cotangent, float32 numpy; the
    last row of a batch of several is all zeros."""
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(h)
    x = rng.standard_normal((t, b, d)).astype(np.float32)
    if b > 1:
        x[:, -1] = 0.0
    ws = [rng.uniform(-s, s, shape).astype(np.float32)
          for shape in ((d, 4 * h), (h, 4 * h), (d, 4 * h), (h, 4 * h))]
    biases = [0.5 * rng.standard_normal(4 * h).astype(np.float32)
              for _ in range(2)]
    cot = rng.standard_normal((t, b, 2 * h)).astype(np.float32)
    return [x, *ws, *biases], cot


def _jax(args, cot, dtype) -> list:
    """[output, each argument's gradient] of mdd_tpu's bilstm, float32."""
    dt = jnp.dtype(dtype)

    def value_and_grads(*a):
        y, vjp = jax.vjp(jax_bilstm, *a)
        return (y,) + vjp(jnp.asarray(cot).astype(dt))

    a = [jnp.asarray(v).astype(dt) for v in args]
    compiled = jax.jit(value_and_grads).lower(*a).compile(
        compiler_options=NO_EXCESS_PRECISION)
    return [np.asarray(o, np.float32) for o in compiled(*a)]


def _port(fn, args, cot, dtype) -> list:
    """[output, each argument's gradient] of a port facade, float32."""
    dt = getattr(torch, dtype)
    a = [torch.from_numpy(v).to(dt).requires_grad_() for v in args]
    y = fn(*a)
    assert y.dtype == dt
    y.backward(torch.from_numpy(cot).to(dt))
    return [y.detach().float().numpy()] + [v.grad.float().numpy() for v in a]


def _both_dtypes(run) -> dict:
    """name -> {dtype: array} of every output of `run(dtype)`."""
    got = {dtype: run(dtype) for dtype in DTYPES}
    return {n: {d: got[d][i] for d in DTYPES} for i, n in enumerate(NAMES)}


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at each element's magnitude (8 significant bits)."""
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("t,b,d,h", CASES)
def test_scan_contract_matches_mdd_tpu_bilstm(t, b, d, h):
    """The outputs within one bfloat16 ulp of mdd_tpu's scan; every
    gradient within 0.1 of bfloat16's own deviation (test_torch_bf16.py's
    rule)."""
    args, cot = _inputs(t, b, d, h, seed=100 * t + 10 * b + h)
    jx = _both_dtypes(lambda dtype: _jax(args, cot, dtype))
    port = _both_dtypes(
        lambda dtype: _port(lstm_cuda.bilstm_scan_cuda, args, cot, dtype))
    out, want = port["output"]["bfloat16"], jx["output"]["bfloat16"]
    assert np.all(np.abs(out - want) <= _bf16_ulp(want))
    for name in NAMES[1:]:
        assert_bf16_close(port[name], jx[name], f"gradient of {name}", k=K)
    assert lstm_cuda.lstm_scan_fwd_kernel.launches == 0   # CPU: plain path
    assert lstm_cuda.lstm_scan_bwd_kernel.launches == 0


@pytest.mark.parametrize("t,b,d,h", CASES)
def test_scan_contract_matches_the_plain_loop(t, b, d, h):
    """The same case against the port's plain loop (ops/lstm.bilstm, whose
    backward is autograd's): the outputs equal, every gradient within the
    same rule."""
    args, cot = _inputs(t, b, d, h, seed=100 * t + 10 * b + h)
    plain = _both_dtypes(lambda dtype: _port(plain_bilstm, args, cot, dtype))
    scan = _both_dtypes(
        lambda dtype: _port(lstm_cuda.bilstm_scan_cuda, args, cot, dtype))
    for dtype in DTYPES:
        np.testing.assert_array_equal(scan["output"][dtype],
                                      plain["output"][dtype])
    for name in NAMES[1:]:
        assert_bf16_close(scan[name], plain[name], f"gradient of {name}",
                          k=K)


def test_the_pallas_contract_fails_the_same_rule():
    """The negative control: the Pallas contract's plain versions
    (bilstm_cuda, c carried in float32 and float32 cotangents) differ from
    mdd_tpu's scan by more than the rule allows on the case the scan
    contract passes, so the rule tells the two contracts apart."""
    t, b, d, h = 12, 3, 16, 8
    args, cot = _inputs(t, b, d, h, seed=100 * t + 10 * b + h)
    jx = _both_dtypes(lambda dtype: _jax(args, cot, dtype))
    pallas = _both_dtypes(
        lambda dtype: _port(lstm_cuda.bilstm_cuda, args, cot, dtype))
    failed = []
    for name in NAMES:
        try:
            assert_bf16_close(pallas[name], jx[name], name, k=K)
        except AssertionError:
            failed.append(name)
    assert "output" in failed and len(failed) >= 5, failed


def test_scan_reference_carries_rounded_c_and_keeps_float32_c():
    """lstm_scan_fwd_reference's cs stream is the unrounded float32 c_t,
    and the next step starts from c_t rounded to bfloat16: mdd_tpu's
    lstm_scan (one direction) gives the same hidden states."""
    rng = np.random.default_rng(3)
    t, b, h = 6, 2, 8
    x_proj = rng.standard_normal((t, 2, b, 4 * h)).astype(np.float32)
    w_hh = rng.uniform(-0.3, 0.3, (2, h, 4 * h)).astype(np.float32)
    hs, cs = lstm_cuda.lstm_scan_fwd(
        torch.from_numpy(x_proj).bfloat16(), torch.from_numpy(w_hh))
    assert hs.dtype == torch.bfloat16 and cs.dtype == torch.float32
    # cs is not rounded; the step after it started from its rounding
    assert not torch.equal(cs, cs.bfloat16().float())
    for d in range(2):
        args = (jnp.asarray(x_proj[:, d], jnp.bfloat16),
                jnp.asarray(w_hh[d], jnp.bfloat16))
        want = jax.jit(lstm_scan).lower(*args).compile(
            compiler_options=NO_EXCESS_PRECISION)(*args)
        np.testing.assert_array_equal(hs[:, d].float().numpy(),
                                      np.asarray(want, np.float32))


def test_scan_kernels_refuse_what_they_do_not_take():
    """On a CPU tensor the wrappers run the plain versions and count no
    launch; the kernels' bindings refuse float32 (the Pallas contract's
    kernels take it) and CPU tensors before anything is built."""
    x_proj = torch.zeros((2, 2, 1, 32))
    w_hh = torch.zeros((2, 8, 32))
    for call in (lambda: lstm_cuda.lstm_scan_fwd_kernel(x_proj, w_hh),
                 lambda: lstm_cuda.lstm_scan_bwd_kernel(
                     x_proj, w_hh, torch.zeros((2, 2, 1, 8)),
                     torch.zeros((2, 2, 1, 8)), torch.zeros((2, 2, 1, 8)))):
        with pytest.raises(TypeError, match="bfloat16"):
            call()
    with pytest.raises(ValueError, match="CUDA tensors"):
        lstm_cuda.lstm_scan_fwd_kernel(x_proj.bfloat16(), w_hh.bfloat16())
    assert lstm_cuda.lstm_scan_fwd_kernel._lib is None
    assert lstm_cuda.lstm_scan_bwd_kernel._lib is None
    assert lstm_cuda.lstm_scan_fwd_kernel.launches == 0
