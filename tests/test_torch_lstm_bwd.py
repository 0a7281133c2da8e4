"""The port's LSTM backward vs mdd_tpu's: the plain version against the
Pallas backward (`_lstm_seq_bwd`, interpret mode on the CPU), the LstmSeq
autograd Function against jax.grad of lstm_pallas.lstm_seq and against
torch autograd through the plain forward, and bilstm_cuda's gradients
against bilstm_pallas's.  Gradients are held at atol 1e-4 / rtol 1e-3
(float32; the sums run in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdd_tpu.ops.lstm_pallas import (_lstm_seq_bwd, _lstm_seq_fwd,
                                     bilstm_pallas)
from mdd_tpu.ops.lstm_pallas import lstm_seq as jax_lstm_seq
from mdd_tpu_torch.ops import lstm_cuda

GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


def _seq_inputs(seed, t, b, h):
    rng = np.random.default_rng(seed)
    x_proj = rng.standard_normal((t, 2, b, 4 * h)).astype(np.float32)
    w_hh = (rng.standard_normal((2, h, 4 * h)) * 0.3).astype(np.float32)
    dhs = rng.standard_normal((t, 2, b, h)).astype(np.float32)
    return x_proj, w_hh, dhs


@pytest.mark.parametrize("t", [1, 6])
@pytest.mark.parametrize("b", [1, 3])
def test_reference_matches_pallas_backward(t, b):
    """dx_proj and dW_hh from the same saved (hs, cs) and cotangent."""
    h = 8
    x_proj, w_hh, dhs = _seq_inputs(10 * t + b, t, b, h)
    hs, cs = _lstm_seq_fwd(jnp.asarray(x_proj), jnp.asarray(w_hh))
    dxp_j, dw_j = _lstm_seq_bwd(jnp.asarray(x_proj), jnp.asarray(w_hh), hs,
                                cs, jnp.asarray(dhs))
    dxp_t, dw_t = lstm_cuda.lstm_seq_bwd_reference(
        torch.from_numpy(x_proj), torch.from_numpy(w_hh),
        torch.from_numpy(np.array(hs)), torch.from_numpy(np.array(cs)),
        torch.from_numpy(dhs))
    assert dxp_t.dtype == torch.float32 and dw_t.dtype == torch.float32
    np.testing.assert_allclose(dxp_t.numpy(), np.asarray(dxp_j), **GRAD_TOL)
    np.testing.assert_allclose(dw_t.numpy(), np.asarray(dw_j), **GRAD_TOL)


# what the kernel's partition over (direction, 16-row batch tile, group of 8
# hidden units) makes interesting: a batch under one tile and one that is no
# multiple of 16, no recurrent step and exactly one, H a multiple of the unit
# group but not of 64
PARTITION_SHAPES = [(1, 4, 24), (2, 4, 24), (1, 24, 40), (2, 24, 40),
                    (5, 24, 8), (3, 17, 72)]


@pytest.mark.parametrize("t,b,h", PARTITION_SHAPES)
def test_reference_matches_pallas_backward_at_partition_shapes(t, b, h):
    x_proj, w_hh, dhs = _seq_inputs(100 * t + b + h, t, b, h)
    hs, cs = _lstm_seq_fwd(jnp.asarray(x_proj), jnp.asarray(w_hh))
    dxp_j, dw_j = _lstm_seq_bwd(jnp.asarray(x_proj), jnp.asarray(w_hh), hs,
                                cs, jnp.asarray(dhs))
    dxp_t, dw_t = lstm_cuda.lstm_seq_bwd_reference(
        torch.from_numpy(x_proj), torch.from_numpy(w_hh),
        torch.from_numpy(np.array(hs)), torch.from_numpy(np.array(cs)),
        torch.from_numpy(dhs))
    np.testing.assert_allclose(dxp_t.numpy(), np.asarray(dxp_j), **GRAD_TOL)
    np.testing.assert_allclose(dw_t.numpy(), np.asarray(dw_j), **GRAD_TOL)
    if t == 1:   # no recurrent step: nothing reaches dW_hh
        assert not dw_t.any()


@pytest.mark.parametrize("t,b,h", PARTITION_SHAPES)
def test_lstm_seq_function_matches_jax_grad_at_partition_shapes(t, b, h):
    x_proj, w_hh, _ = _seq_inputs(7 * t + b + h, t, b, h)

    def loss(xp, w):
        return jnp.sum(jnp.tanh(jax_lstm_seq(xp, w)) * 0.7)

    val_j, (gx_j, gw_j) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(x_proj), jnp.asarray(w_hh))
    val_t, gx_t, gw_t = _port_grads(x_proj, w_hh, lstm_cuda.lstm_seq)
    np.testing.assert_allclose(val_t, float(val_j), rtol=1e-5)
    np.testing.assert_allclose(gx_t, np.asarray(gx_j), **GRAD_TOL)
    np.testing.assert_allclose(gw_t, np.asarray(gw_j), **GRAD_TOL)


def test_reference_matches_pallas_backward_bf16():
    """bfloat16 x_proj, hs and cs (c read rounded, as the Pallas kernel
    reads it): dgates round to bf16, so a 1-ulp difference (2^-8
    relative) can carry into later steps; held at 2e-2 of each output's
    largest magnitude."""
    t, b, h = 5, 2, 8
    x_proj, w_hh, dhs = _seq_inputs(3, t, b, h)
    xb = jnp.asarray(x_proj, jnp.bfloat16)
    hs, cs = _lstm_seq_fwd(xb, jnp.asarray(w_hh))
    dxp_j, dw_j = _lstm_seq_bwd(xb, jnp.asarray(w_hh), hs, cs,
                                jnp.asarray(dhs))
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    dxp_t, dw_t = lstm_cuda.lstm_seq_bwd_reference(
        bf(x_proj), torch.from_numpy(w_hh), bf(hs), bf(cs),
        torch.from_numpy(dhs))
    assert dxp_t.dtype == torch.bfloat16 and dw_t.dtype == torch.float32
    for got, want in ((dxp_t.float().numpy(), np.asarray(dxp_j, np.float32)),
                      (dw_t.numpy(), np.asarray(dw_j))):
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 2e-2 * scale


def _port_grads(x_proj, w_hh, fn):
    xp = torch.from_numpy(x_proj).requires_grad_()
    w = torch.from_numpy(w_hh).requires_grad_()
    loss = (torch.tanh(fn(xp, w)) * 0.7).sum()
    loss.backward()
    return loss.item(), xp.grad.numpy(), w.grad.numpy()


def test_lstm_seq_function_matches_jax_grad():
    x_proj, w_hh, _ = _seq_inputs(2, 6, 3, 4)

    def loss(xp, w):
        return jnp.sum(jnp.tanh(jax_lstm_seq(xp, w)) * 0.7)

    val_j, (gx_j, gw_j) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(x_proj), jnp.asarray(w_hh))
    val_t, gx_t, gw_t = _port_grads(x_proj, w_hh, lstm_cuda.lstm_seq)
    np.testing.assert_allclose(val_t, float(val_j), rtol=1e-5)
    np.testing.assert_allclose(gx_t, np.asarray(gx_j), **GRAD_TOL)
    np.testing.assert_allclose(gw_t, np.asarray(gw_j), **GRAD_TOL)


def test_lstm_seq_function_matches_autograd_of_plain_forward():
    """The hand-written backward against torch's own autodiff of the
    plain forward loop, on the same inputs."""
    x_proj, w_hh, _ = _seq_inputs(4, 7, 2, 8)
    plain = lambda xp, w: lstm_cuda.lstm_seq_fwd_reference(xp, w)[0]
    val_a, gx_a, gw_a = _port_grads(x_proj, w_hh, plain)
    val_t, gx_t, gw_t = _port_grads(x_proj, w_hh, lstm_cuda.lstm_seq)
    assert val_t == pytest.approx(val_a, rel=1e-6)
    np.testing.assert_allclose(gx_t, gx_a, **GRAD_TOL)
    np.testing.assert_allclose(gw_t, gw_a, **GRAD_TOL)
    assert lstm_cuda.lstm_bwd_kernel.launches == 0   # CPU: the plain path


@pytest.mark.parametrize("with_bias", [False, True])
def test_bilstm_cuda_gradients_match_bilstm_pallas(with_bias):
    """Through the facade: the input projections' gradients come from
    autograd, the recurrence's from LstmSeq."""
    rng = np.random.default_rng(5)
    t, b, d_in, h = 6, 3, 10, 8
    s = 1.0 / np.sqrt(h)
    x = rng.standard_normal((t, b, d_in)).astype(np.float32)
    ws = [rng.uniform(-s, s, shape).astype(np.float32)
          for shape in ((d_in, 4 * h), (h, 4 * h), (d_in, 4 * h), (h, 4 * h))]
    if with_bias:
        ws += [rng.uniform(-s, s, 4 * h).astype(np.float32)
               for _ in range(2)]
    cot = rng.standard_normal((t, b, 2 * h)).astype(np.float32)

    def loss_j(*args):
        return jnp.sum(bilstm_pallas(*args) * cot)

    grads_j = jax.grad(loss_j, argnums=tuple(range(len(ws) + 1)))(
        jnp.asarray(x), *map(jnp.asarray, ws))
    args_t = [torch.from_numpy(a).requires_grad_() for a in [x] + ws]
    (lstm_cuda.bilstm_cuda(*args_t) * torch.from_numpy(cot)).sum().backward()
    for got, want in zip(args_t, grads_j):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL)


def test_backward_binding_refuses_cpu_tensors():
    """The backward binding checks its inputs before it builds or launches
    anything: a CPU tensor is an error, never a silent plain run."""
    x_proj, w_hh, dhs = _seq_inputs(8, 2, 1, 8)
    hs, cs = lstm_cuda.lstm_seq_fwd_reference(torch.from_numpy(x_proj),
                                              torch.from_numpy(w_hh))
    with pytest.raises(ValueError, match="CUDA"):
        lstm_cuda.lstm_bwd_kernel(torch.from_numpy(x_proj),
                                  torch.from_numpy(w_hh), hs, cs,
                                  torch.from_numpy(dhs))
    assert lstm_cuda.lstm_bwd_kernel.launches == 0
