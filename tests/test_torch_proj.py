"""The BiLSTMs' input projections by dtype (ops/lstm.projections): in
bfloat16 `Bf16Projections`, whose plain version on the CPU must give the
float32 route's bits (the same products, rounded at the same points), for
the projections and every gradient, alone and under each recurrence; in
float32 the SGEMMs untouched.  Also the trace counters of both routes
and what the Function keeps for its backward."""

import pytest
import torch

from mdd_tpu_torch.models.ctc_model import RECURRENCES, ModelConfig
from mdd_tpu_torch.ops import lstm, lstm_cuda
from mdd_tpu_torch.train.loop import Trainer
from mdd_tpu_torch.utils import trace
from test_torch_trace import TINY, _loader, corpus  # noqa: F401 (fixture)

D, H, B = 24, 8, 3
BF16 = torch.bfloat16


def _sgemm_graph(x, w_ih_fwd, w_ih_bwd, b_fwd=None, b_bwd=None):
    """The float32 route as every recurrence ran it in bfloat16 before
    `Bf16Projections`: float32 products, the bias added in float32, the
    stack rounded once."""
    xf = lstm._dot_f32(x, w_ih_fwd)
    xb = lstm._dot_f32(torch.flip(x, (0,)), w_ih_bwd)
    if b_fwd is not None:
        xf = xf + b_fwd
    if b_bwd is not None:
        xb = xb + b_bwd
    return torch.stack([xf, xb], dim=1).to(x.dtype)


def _leaves(t, bias, seed):
    """float32 leaves as the model holds them: x as (B, T, D) and the
    layer's weights and biases."""
    g = torch.Generator().manual_seed(seed)
    s = H ** -0.5
    x = torch.randn((B, t, D), generator=g)
    w = [(torch.rand(shape, generator=g) * 2 - 1) * s
         for shape in ((D, 4 * H), (H, 4 * H), (D, 4 * H), (H, 4 * H))]
    b = [(torch.rand(4 * H, generator=g) * 2 - 1) * s if bias else None
         for _ in range(2)]
    return [a if a is None else a.requires_grad_() for a in (x, *w, *b)]


def _bf16_args(leaves):
    """bfloat16 arguments as BiLstmLayer makes them: x time-major (a
    transposed view), every parameter cast."""
    x, *rest = leaves
    return [x.to(BF16).transpose(0, 1)] + [
        None if a is None else a.to(BF16) for a in rest]


def _grads(out, cot, leaves):
    present = [a for a in leaves if a is not None]
    return torch.autograd.grad(out, present, cot)


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    bits = torch.int16 if got.dtype == BF16 else torch.int32
    assert torch.equal(got.contiguous().view(bits),
                       want.contiguous().view(bits))


@pytest.mark.parametrize("t", [1, 6])
@pytest.mark.parametrize("bias", [False, True])
def test_bf16_projections_equal_the_sgemm_graph_bit_for_bit(t, bias):
    leaves = _leaves(t, bias, seed=t + 10 * bias)
    x, w_f, _, w_b, _, b_f, b_b = _bf16_args(leaves)
    got = lstm.projections(x, w_f, w_b, b_f, b_b)
    want = _sgemm_graph(x, w_f, w_b, b_f, b_b)
    _same_bits(got, want)
    cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(t)
                      ).to(BF16)
    used = [leaves[i] for i in (0, 1, 3, 5, 6)]
    for g_got, g_want in zip(_grads(got, cot, used), _grads(want, cot, used)):
        _same_bits(g_got, g_want)


@pytest.mark.parametrize("t", [1, 6])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("route", ["plain", "pallas", "scan"])
def test_each_recurrence_keeps_its_bits_in_bf16(route, bias, t,
                                                 monkeypatch):
    """The route's output and the gradients of x, both w_ih, both w_hh
    and the biases, with the projections through Bf16Projections and
    through the SGEMM graph."""
    leaves = _leaves(t, bias, seed=100 + t + 10 * bias)
    cot = torch.randn((t, B, 2 * H),
                      generator=torch.Generator().manual_seed(t)).to(BF16)
    rnn = RECURRENCES[route]
    got = rnn(*_bf16_args(leaves))
    got_grads = _grads(got, cot, leaves)
    monkeypatch.setattr(lstm, "projections", _sgemm_graph)
    monkeypatch.setattr(lstm_cuda, "projections", _sgemm_graph)
    want = rnn(*_bf16_args(leaves))
    _same_bits(got, want)
    for g_got, g_want in zip(got_grads, _grads(want, cot, leaves)):
        _same_bits(g_got, g_want)


def test_float32_never_enters_the_function(monkeypatch):
    def refuse(*a):
        raise AssertionError("float32 operands in Bf16Projections")

    monkeypatch.setattr(lstm.Bf16Projections, "apply", refuse)
    leaves = _leaves(5, True, seed=3)
    x, *rest = leaves
    args = [x.transpose(0, 1)] + [rest[i] for i in (0, 2, 4, 5)]
    got = lstm.projections(*args)
    assert got.dtype == torch.float32
    _same_bits(got, _sgemm_graph(*args))
    # one bfloat16 operand among float32 ones is no bfloat16 product either
    mixed = [args[0].to(BF16)] + args[1:]
    assert lstm.projections(*mixed).dtype == BF16


def test_the_function_saves_no_float32_tensor():
    x, w_f, _, w_b, _, b_f, b_b = _bf16_args(_leaves(4, True, seed=7))
    out = lstm.Bf16Projections.apply(x, w_f, w_b, b_f, b_b)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 4 and all(s.dtype == BF16 for s in saved)
    # the SGEMM graph it replaces kept float32 copies of x
    old = _sgemm_graph(x, w_f, w_b, b_f, b_b)
    node, kept = old.grad_fn, []
    stack = [node]
    while stack:
        node = stack.pop()
        kept += [getattr(node, a) for a in dir(node)
                 if a.startswith("_saved_")
                 and isinstance(getattr(node, a), torch.Tensor)]
        stack += [f for f, _ in node.next_functions if f is not None]
    assert any(k.dtype == torch.float32 and k.shape[-1] == D for k in kept)


@pytest.mark.parametrize("dtype,route", [("bfloat16", "proj.bf16_products"),
                                         ("float32", "proj.f32_products")])
@pytest.mark.parametrize("pallas", [True, False])
def test_a_traced_step_counts_six_products_a_bilstm(corpus, dtype, route,
                                                    pallas):
    """2 forward products a layer (one a direction), dX and dW_ih of each
    direction in the backward; the other route's counter stays absent."""
    cfg = ModelConfig(**dict(TINY, compute_dtype=dtype,
                             use_pallas_lstm=pallas))
    loader = _loader(corpus)
    trainer = Trainer(cfg, seed=5, device="cpu", device_frontend=True)
    batch = next(iter(loader))
    arrays = trainer.cached_arrays(loader.cache, batch)
    trace.disable()
    trace.reset()
    try:
        trace.enable()
        trainer.train_step(arrays, torch.zeros(4))
        counters = trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.reset()
    layers = cfg.rnn_layers + 1          # the acoustic stack and the text
    assert layers == 3
    assert {k: v for k, v in counters.items() if k.startswith("proj.")} \
        == {route: 6 * layers}


def test_tracing_off_counts_nothing():
    trace.disable()
    trace.reset()
    x, w_f, _, w_b, _, b_f, b_b = _bf16_args(_leaves(3, True, seed=1))
    out = lstm.projections(x, w_f, w_b, b_f, b_b)
    out.float().sum().backward()
    assert trace.snapshot()["counters"] == {}
