"""Port LSTM ops vs mdd_tpu's: the kernel's plain version against the
Pallas forward (interpret mode on the CPU), the plain scan against the
lax.scan path, and the CPU dispatch of the kernel wrapper."""

import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdd_tpu.ops import lstm as jax_lstm
from mdd_tpu.ops.lstm_pallas import _lstm_seq_fwd, bilstm_pallas
from mdd_tpu_torch.ops import lstm as port_lstm
from mdd_tpu_torch.ops import lstm_cuda
from test_torch_lstm_bwd import PARTITION_SHAPES


def _seq_inputs(seed, t, b, h):
    rng = np.random.default_rng(seed)
    x_proj = rng.standard_normal((t, 2, b, 4 * h)).astype(np.float32)
    s = 1.0 / np.sqrt(h)
    w_hh = rng.uniform(-s, s, (2, h, 4 * h)).astype(np.float32)
    return x_proj, w_hh


def _bilstm_inputs(seed, t, b, d_in, h):
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(h)
    x = rng.standard_normal((t, b, d_in)).astype(np.float32)
    ws = [rng.uniform(-s, s, shape).astype(np.float32)
          for shape in ((d_in, 4 * h), (h, 4 * h), (d_in, 4 * h), (h, 4 * h))]
    bias = [rng.standard_normal(4 * h).astype(np.float32) for _ in range(2)]
    return x, ws, bias


@pytest.mark.parametrize("t,b,h", [(1, 1, 8), (7, 3, 8), (12, 5, 16)])
def test_reference_matches_pallas_forward_fp32(t, b, h):
    """hs and cs both; float32 reproduces the Pallas kernel up to the
    summation order of the recurrent dot (atol 1e-5)."""
    x_proj, w_hh = _seq_inputs(t * 100 + b, t, b, h)
    hs_j, cs_j = _lstm_seq_fwd(jnp.asarray(x_proj), jnp.asarray(w_hh))
    hs_t, cs_t = lstm_cuda.lstm_seq_fwd_reference(torch.from_numpy(x_proj),
                                                  torch.from_numpy(w_hh))
    np.testing.assert_allclose(hs_t.numpy(), np.asarray(hs_j), atol=1e-5)
    np.testing.assert_allclose(cs_t.numpy(), np.asarray(cs_j), atol=1e-5)


@pytest.mark.parametrize("t,b,h", PARTITION_SHAPES)
def test_reference_matches_pallas_forward_at_partition_shapes(t, b, h):
    """The shapes the kernel's partition over (direction, 16-row batch
    tile, group of 8 hidden units) makes interesting: a batch under one
    tile and one that is no multiple of 16, one step and two, H a multiple
    of 8 but not of 64.  float32 reproduces the Pallas kernel up to the
    summation order of the recurrent dot (atol 1e-5)."""
    x_proj, w_hh = _seq_inputs(100 * t + b + h, t, b, h)
    hs_j, cs_j = _lstm_seq_fwd(jnp.asarray(x_proj), jnp.asarray(w_hh))
    hs_t, cs_t = lstm_cuda.lstm_seq_fwd_reference(torch.from_numpy(x_proj),
                                                  torch.from_numpy(w_hh))
    assert hs_t.shape == cs_t.shape == (t, 2, b, h)
    np.testing.assert_allclose(hs_t.numpy(), np.asarray(hs_j), atol=1e-5)
    np.testing.assert_allclose(cs_t.numpy(), np.asarray(cs_j), atol=1e-5)


def test_reference_matches_pallas_forward_bf16():
    """bfloat16 x_proj: h rounds to bf16 every step while c stays float32
    in both; a 1-ulp rounding difference of h (2^-8 relative) can carry
    through later steps, hence 2e-2."""
    x_proj, w_hh = _seq_inputs(7, 10, 4, 16)
    hs_j, cs_j = _lstm_seq_fwd(jnp.asarray(x_proj, jnp.bfloat16),
                               jnp.asarray(w_hh))
    hs_t, cs_t = lstm_cuda.lstm_seq_fwd_reference(
        torch.from_numpy(x_proj).bfloat16(), torch.from_numpy(w_hh))
    assert hs_t.dtype == cs_t.dtype == torch.bfloat16
    np.testing.assert_allclose(hs_t.float().numpy(),
                               np.asarray(hs_j, np.float32), atol=2e-2)
    np.testing.assert_allclose(cs_t.float().numpy(),
                               np.asarray(cs_j, np.float32), atol=2e-2)


@pytest.mark.parametrize("with_bias", [False, True])
def test_bilstm_matches_scan(with_bias):
    x, ws, bias = _bilstm_inputs(3, 9, 3, 10, 6)
    b = bias if with_bias else [None, None]
    ref = jax_lstm.bilstm(jnp.asarray(x), *map(jnp.asarray, ws),
                          *(None if v is None else jnp.asarray(v) for v in b))
    out = port_lstm.bilstm(torch.from_numpy(x), *map(torch.from_numpy, ws),
                           *(None if v is None else torch.from_numpy(v)
                             for v in b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_bilstm_cuda_facade_matches_bilstm_pallas():
    x, ws, bias = _bilstm_inputs(4, 8, 2, 12, 8)
    ref = bilstm_pallas(jnp.asarray(x), *map(jnp.asarray, ws),
                        *map(jnp.asarray, bias))
    out = lstm_cuda.bilstm_cuda(torch.from_numpy(x), *map(torch.from_numpy, ws),
                                *map(torch.from_numpy, bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_lstm_scan_matches_jax():
    rng = np.random.default_rng(5)
    x_proj = rng.standard_normal((6, 3, 4 * 5)).astype(np.float32)
    w_hh = (rng.standard_normal((5, 4 * 5)) * 0.3).astype(np.float32)
    ref = jax_lstm.lstm_scan(jnp.asarray(x_proj), jnp.asarray(w_hh))
    out = port_lstm.lstm_scan(torch.from_numpy(x_proj),
                              torch.from_numpy(w_hh))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_cpu_tensors_take_the_plain_path_without_counting():
    x_proj, w_hh = _seq_inputs(6, 5, 2, 8)
    before = lstm_cuda.lstm_fwd_kernel.launches
    hs, cs = lstm_cuda.lstm_seq_fwd(torch.from_numpy(x_proj),
                                    torch.from_numpy(w_hh))
    ref_hs, ref_cs = lstm_cuda.lstm_seq_fwd_reference(
        torch.from_numpy(x_proj), torch.from_numpy(w_hh))
    assert torch.equal(hs, ref_hs) and torch.equal(cs, ref_cs)
    assert lstm_cuda.lstm_fwd_kernel.launches == before == 0


def test_kernel_binding_refuses_cpu_tensors():
    """The binding checks its inputs before it builds or launches
    anything: a CPU tensor is an error, never a silent plain run."""
    x_proj, w_hh = _seq_inputs(8, 2, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        lstm_cuda.lstm_fwd_kernel(torch.from_numpy(x_proj),
                                  torch.from_numpy(w_hh))
    assert lstm_cuda.lstm_fwd_kernel.launches == 0


@pytest.mark.parametrize("kernel", ["lstm_fwd", "lstm_bwd", "lstm_scan_fwd",
                                    "lstm_scan_bwd"])
def test_wrappers_hold_their_barrier_counters_until_the_launch(monkeypatch,
                                                               kernel):
    """The zeroed barrier counters a launch gets are alive, and zero, when
    the launch is enqueued: freed any earlier, their block can go to an
    allocation of another thread (evaluate's staging thread) whose copy
    lands before the kernel runs.  The launch itself is stubbed here; the
    race runs on the card in test_torch_cuda.py."""
    made, seen = [], []
    fresh = lstm_cuda._barrier_counters

    def counters(b, device):
        c = fresh(b, device)
        made.append(weakref.ref(c))
        return c

    def launch(self, device, *args):
        c = made[-1]()
        seen.append(c is not None and c.data_ptr() == args[self.n_pointers - 1]
                    and not c.any())

    monkeypatch.setattr(lstm_cuda, "_barrier_counters", counters)
    monkeypatch.setattr(lstm_cuda, "_check_lstm_inputs",
                        lambda x, w, units: (x.shape[0], x.shape[2],
                                             x.shape[3] // 4))
    monkeypatch.setattr(lstm_cuda._LstmBinding, "_launch", launch)
    t, b, h = 3, 2, 8
    x_proj, w_hh = (torch.from_numpy(a) for a in _seq_inputs(9, t, b, h))
    if kernel == "lstm_fwd":
        lstm_cuda.LstmFwdKernel()(x_proj, w_hh)
    elif kernel == "lstm_scan_fwd":
        lstm_cuda.LstmScanFwdKernel()(x_proj.bfloat16(), w_hh.bfloat16())
    elif kernel == "lstm_scan_bwd":
        x_proj, w_hh = x_proj.bfloat16(), w_hh.bfloat16()
        hs, cs = lstm_cuda.lstm_scan_fwd_reference(x_proj, w_hh)
        four_h = torch.empty((t, 2, b, 4 * h))
        # dx_proj, dW_hh, z, dgates, the exchange, dW_hh's step scratch
        buffers = (torch.empty_like(x_proj), torch.empty_like(w_hh), four_h,
                   torch.empty_like(four_h), torch.empty(1), torch.empty(1))
        k = lstm_cuda.LstmScanBwdKernel()
        k.run_parts(x_proj, w_hh, hs, cs, torch.ones((t, 2, b, h)), buffers,
                    k.ALL)
    else:
        hs, cs = lstm_cuda.lstm_seq_fwd_reference(x_proj, w_hh)
        buffers = (torch.empty_like(x_proj), torch.empty((2, h, 4 * h)),
                   torch.empty((t, 2, b, 4 * h)), torch.empty((1, 2, h, 4 * h)),
                   torch.empty(1))
        k = lstm_cuda.LstmBwdKernel()
        k.run_parts(x_proj, w_hh, hs, cs, torch.ones((t, 2, b, h)), buffers,
                    k.ALL)
    assert seen == [True]
