"""The port's CTC loss (ops/ctc_loss.ctc_loss -> ops/ctc_cuda.CtcLoss, the
plain versions of csrc/ctc_loss.cu's two kernels on CPU tensors) against
mdd_tpu's custom-VJP `ctc_loss` on the same numpy inputs: nll within 1e-5
(rtol 1e-6 on the 1e30 of a row no alignment fits), the gradient at the
log-probs within atol 1e-4 / rtol 1e-3 (both -posterior times the
cotangent), and the alphas of every frame before a row's input length
against mdd_tpu's `_alpha_scan`.  Then the wrappers' refusals on CPU
tensors (before any build), a CPU call that launches nothing, and the text
BiLSTM's route: on the LSTM kernels' autograd Function in a float32
`use_pallas_lstm` model (log-probs and every gradient against mdd_tpu's),
on the plain loop in bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdd_tpu.models.ctc_model import CTCAttentionModel as JaxModel
from mdd_tpu.models.ctc_model import ModelConfig as JaxConfig
from mdd_tpu.ops.ctc_loss import _alpha_scan, _prep
from mdd_tpu.ops.ctc_loss import ctc_loss as jax_ctc_loss
from mdd_tpu_torch.convert import flax_to_torch
from mdd_tpu_torch.models.ctc_model import CTCAttentionModel, ModelConfig
from mdd_tpu_torch.ops import build, ctc_cuda, lstm_cuda
from mdd_tpu_torch.ops.ctc_loss import ctc_loss
from mdd_tpu_torch.ops.lstm import bilstm
from test_torch_model import SMALL, _inputs, _perturbed

NLL_TOL = dict(rtol=1e-6, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _case(name):
    """(logits (T, B, C), input_lengths, labels, label_lengths, cotangent
    weights), numpy, seeded by the case."""
    seed = CASES.index(name)
    rng = np.random.default_rng(seed)
    t, b, c, l = (6, 5, 5, 3) if name == "input length 0 (T=6, B=5, C=5)" \
        else (14, 6, 7, 5)
    logits = rng.standard_normal((t, b, c)).astype(np.float32) * 2
    labels = rng.integers(1, c, (b, l)).astype(np.int64)
    label_lengths = rng.integers(1, l + 1, b).astype(np.int64)
    input_lengths = rng.integers(min(2 * l + 1, t), t + 1, b).astype(
        np.int64)
    weights = np.linspace(0.5, 1.5, b).astype(np.float32)
    if name == "ragged":
        input_lengths[:] = [14, 11, 12, 13, 12, 14]
        label_lengths[:] = [5, 2, 4, 1, 3, 5]
    elif name == "label length 0":
        label_lengths[[1, 4]] = 0
    elif name == "a repeat that needs a blank":
        labels[2, :4] = 3                     # 4 labels + 3 blanks: 7 frames
        label_lengths[2], input_lengths[2] = 4, 7
        labels[3, 1] = labels[3, 0]
        label_lengths[3] = 2
    elif name == "an infeasible row":
        labels[2, :4] = 4
        label_lengths[2], input_lengths[2] = 4, 6
        label_lengths[4], input_lengths[4] = 5, 4
    elif name == "input lengths 0 and 1":
        input_lengths[:4] = [0, 0, 1, 1]
        label_lengths[:4] = [0, 1, 0, 1]
    elif name == "a padded (mask False) row":
        # pad_batch_to repeats the last real row; the loss weighs it 0
        for a in (logits.transpose(1, 0, 2), labels, label_lengths,
                  input_lengths):
            a[-1] = a[-2]
        weights[-1] = 0.0
    elif name == "input length 0 (T=6, B=5, C=5)":
        input_lengths[:] = [0, 0, 6, 5, 4]
        label_lengths[:] = [1, 0, 3, 2, 1]
    return logits, input_lengths, labels, label_lengths, weights


CASES = ["ragged", "label length 0", "a repeat that needs a blank",
         "an infeasible row", "input lengths 0 and 1",
         "a padded (mask False) row", "input length 0 (T=6, B=5, C=5)"]


def _log_softmax(logits):
    return np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


def _jax_loss(lp, il, labels, ll, weights):
    """mdd_tpu's nll, d(sum w * nll)/d log_probs and `_alpha_scan`'s alphas."""
    args = tuple(jnp.asarray(a) for a in (il, labels, ll))
    nll, grad = jax.value_and_grad(
        lambda x: jnp.sum(jax_ctc_loss(x, *args) * weights))(jnp.asarray(lp))
    nll = jax_ctc_loss(jnp.asarray(lp), *args)
    prep = _prep(jnp.asarray(lp), args[1], args[2], 0)
    alphas, _ = _alpha_scan(jnp.asarray(lp), args[0], args[2], *prep)
    return np.asarray(nll), np.asarray(grad), np.asarray(alphas)


@pytest.mark.parametrize("name", CASES)
def test_ctc_loss_matches_mdd_tpu(name):
    logits, il, labels, ll, w = _case(name)
    lp_np = _log_softmax(logits)
    want_nll, want_grad, want_alphas = _jax_loss(lp_np, il, labels, ll, w)
    lp = torch.from_numpy(lp_np).requires_grad_(True)
    nll = ctc_loss(lp, *(torch.from_numpy(a) for a in (il, labels, ll)))
    (nll * torch.from_numpy(w)).sum().backward()
    assert nll.dtype == torch.float32 and nll.shape == (len(il),)
    np.testing.assert_allclose(nll.detach().numpy(), want_nll, **NLL_TOL)
    np.testing.assert_allclose(lp.grad.numpy(), want_grad, **GRAD_TOL)
    _, alphas = ctc_cuda.ctc_loss_fwd_reference(
        torch.from_numpy(lp_np), *(torch.from_numpy(a)
                                   for a in (il, labels, ll)))
    for row, n in enumerate(il):
        np.testing.assert_allclose(alphas[:n, row].numpy(),
                                   want_alphas[:n, row], **NLL_TOL)
    # no gradient past a row's input length, on an infeasible row or a
    # row the loss weighs 0
    t_idx = np.arange(lp_np.shape[0])[:, None]
    dead = (t_idx >= il[None]) | (want_nll >= 5e29)[None] | (w == 0)[None]
    assert not lp.grad.numpy()[dead].any()


def test_input_length_0_counts_frame_0_as_mdd_tpu_does():
    """A row of input length 0 has mdd_tpu's finite nll (frame 0's
    emission of its one label, or of the blank) and zero gradient."""
    logits, il, labels, ll, w = _case("input length 0 (T=6, B=5, C=5)")
    lp_np = _log_softmax(logits)
    want_nll, _, _ = _jax_loss(lp_np, il, labels, ll, w)
    lp = torch.from_numpy(lp_np).requires_grad_(True)
    nll = ctc_loss(lp, *(torch.from_numpy(a) for a in (il, labels, ll)))
    nll.sum().backward()
    assert nll[0].item() == pytest.approx(-lp_np[0, 0, labels[0, 0]],
                                          rel=1e-6)
    assert nll[1].item() == pytest.approx(-lp_np[0, 1, 0], rel=1e-6)
    np.testing.assert_allclose(nll[:2].detach().numpy(), want_nll[:2],
                               **NLL_TOL)
    assert np.all(want_nll[:2] < 1e29)
    assert not lp.grad[:, :2].any()


def test_ctc_loss_on_cpu_tensors_launches_no_kernel(monkeypatch):
    """The plain versions on CPU tensors: no kernel built, none launched."""
    def no_build(*a, **k):
        raise AssertionError("a CPU call built a kernel")

    monkeypatch.setattr(build, "load", no_build)
    kernels = (ctc_cuda.ctc_alpha_kernel, ctc_cuda.ctc_beta_grad_kernel)
    before = [k.launches for k in kernels]
    logits, il, labels, ll, _ = _case("ragged")
    lp = torch.from_numpy(_log_softmax(logits)).requires_grad_(True)
    ctc_loss(lp, *(torch.from_numpy(a) for a in (il, labels, ll))
             ).sum().backward()
    assert [k.launches for k in kernels] == before
    assert lp.grad is not None and torch.isfinite(lp.grad).all()


def _good():
    logits, il, labels, ll, _ = _case("ragged")
    return [torch.from_numpy(_log_softmax(logits)), torch.from_numpy(il),
            torch.from_numpy(labels), torch.from_numpy(ll)]


def _bad(which):
    lp, il, labels, ll = _good()
    blank = 0
    if which == "float64 log_probs":
        lp = lp.double()
    elif which == "2-D log_probs":
        lp = lp[0]
    elif which == "strided classes":
        lp = lp[:, :, ::2]
    elif which == "int32 lengths":
        il = il.int()
    elif which == "labels of another batch":
        labels = labels[:-1]
    elif which == "non-contiguous lengths":
        ll = torch.stack([ll, ll], 1)[:, 0]
    elif which == "1,024 slots":
        labels = torch.ones((labels.shape[0], 512), dtype=torch.int64)
    elif which == "1,025 classes":
        lp = torch.zeros((4, labels.shape[0], 1025))
    elif which == "blank outside the classes":
        blank = lp.shape[2]
    elif which == "2^31 frame-class pairs":
        lp = torch.zeros((1, labels.shape[0], 1024)).expand(2 ** 21, -1, -1)
    return (lp, il, labels, ll), blank


REFUSALS = [("float64 log_probs", TypeError, "float32"),
            ("2-D log_probs", ValueError, r"\(T, B, C\)"),
            ("strided classes", ValueError, "contiguous"),
            ("int32 lengths", TypeError, "int64"),
            ("labels of another batch", ValueError, "rows"),
            ("non-contiguous lengths", ValueError, "contiguous"),
            ("1,024 slots", ValueError, "1023"),
            ("1,025 classes", ValueError, "1024"),
            ("blank outside the classes", ValueError, "blank"),
            ("2^31 frame-class pairs", ValueError, "32 bits"),
            ("cpu tensors", ValueError, "CUDA")]


@pytest.mark.parametrize("which,error,match", REFUSALS)
@pytest.mark.parametrize("kernel", ["ctc_alpha", "ctc_beta_grad"])
def test_kernel_wrappers_refuse_on_the_cpu(monkeypatch, kernel, which, error,
                                           match):
    """Each refusal shows on CPU tensors, before anything is built."""
    monkeypatch.setattr(build, "load", None)
    args, blank = _bad(which)
    if kernel == "ctc_alpha":
        call = lambda: ctc_cuda.ctc_alpha_kernel(*args, blank=blank)
    else:
        t, b = args[0].shape[:2]
        s = 2 * args[2].shape[-1] + 1
        alphas, vec = torch.zeros((1, 1, 1)).expand(t, b, s), torch.zeros(b)
        if which == "cpu tensors":
            alphas = alphas.contiguous()
        call = lambda: ctc_cuda.ctc_beta_grad_kernel(
            *args, alphas, vec, vec, blank=blank)
    with pytest.raises(error, match=match):
        call()


@pytest.mark.parametrize("which,match", [
    ("alphas of another width", "slots"), ("float64 g", "float32"),
    ("g of another batch", r"\(6,\)")])
def test_backward_wrapper_refuses_bad_cotangents(monkeypatch, which, match):
    monkeypatch.setattr(build, "load", None)
    lp, il, labels, ll = _good()
    t, b = lp.shape[:2]
    alphas, nll, g = torch.zeros((t, b, 11)), torch.zeros(b), torch.zeros(b)
    if which == "alphas of another width":
        alphas = torch.zeros((t, b, 9))
    elif which == "float64 g":
        g = g.double()
    else:
        g = torch.zeros(b + 1)
    with pytest.raises(ValueError, match=match):
        ctc_cuda.ctc_beta_grad_kernel(lp, il, labels, ll, alphas, nll, g)


@pytest.mark.parametrize("name", CASES)
def test_gradient_scratch_holds_a_weight_a_frame_row_and_slot(name):
    """ctc_beta_grad's (T, B, S) weights scratch: S the extended labels'
    width that the plain version builds (mdd_tpu's `_prep`)."""
    logits, il, labels, ll, _ = _case(name)
    lp = torch.from_numpy(_log_softmax(logits))
    labels = torch.from_numpy(labels)
    ext, _, _ = ctc_cuda._extended_labels(labels, torch.from_numpy(ll), 0)
    assert ctc_cuda.weights_shape(lp, labels) == (*lp.shape[:2],
                                                  ext.shape[1])


def test_backward_wrapper_hands_the_kernel_its_scratch(monkeypatch):
    """On a stand-in for the launch: one argument a parameter of
    `mdd_ctc_beta_grad` in csrc/ctc_loss.cu (its stream last), the weights
    scratch (T, B, S) float32 before the gradient, the gradient laid out
    as the log-probs."""
    lp, il, labels, ll = _good()
    t, b = lp.shape[:2]
    s = 2 * labels.shape[1] + 1
    made, seen = [], []
    real_empty = torch.empty

    def empty(*args, **kw):
        out = real_empty(*args, **kw)
        made.append(out)
        return out

    monkeypatch.setattr(ctc_cuda.torch, "empty", empty)
    monkeypatch.setattr(ctc_cuda, "_check_device", lambda lp: None)
    kernel = ctc_cuda.CtcBetaGradKernel()
    monkeypatch.setattr(kernel, "_launch",
                        lambda device, *args: seen.append(args))
    grad = kernel(lp, il, labels, ll, torch.zeros((t, b, s)),
                  torch.zeros(b), torch.ones(b))
    args = seen[0]
    source = (build.CSRC / "ctc_loss.cu").read_text()
    params = source.split("int mdd_ctc_beta_grad(")[1].split(")")[0]
    assert len(args) + 1 == len(kernel.argtypes) + 1 == params.count(",") + 1
    weights = next(x for x in made if x.data_ptr() == args[-4])
    assert tuple(weights.shape) == (t, b, s) == ctc_cuda.weights_shape(
        lp, labels)
    assert weights.dtype == torch.float32
    assert args[-3:] == (grad.data_ptr(), grad.stride(0), grad.stride(1))
    assert grad.shape == lp.shape and grad.stride() == lp.stride()


def _count_lstm_seq(monkeypatch):
    """Counts of lstm_cuda.lstm_seq_fwd / lstm_seq_bwd calls (LstmSeq's two
    passes), the plain versions still doing the work."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = lstm_cuda.lstm_seq_fwd, lstm_cuda.lstm_seq_bwd

    def counted_fwd(*a):
        calls["fwd"] += 1
        return fwd(*a)

    def counted_bwd(*a):
        calls["bwd"] += 1
        return bwd(*a)

    monkeypatch.setattr(lstm_cuda, "lstm_seq_fwd", counted_fwd)
    monkeypatch.setattr(lstm_cuda, "lstm_seq_bwd", counted_bwd)
    return calls


def test_float32_kernel_model_runs_its_text_branch_on_lstm_seq(monkeypatch):
    """use_pallas_lstm in float32: the text BiLSTM is bilstm_cuda, so a
    forward makes rnn_layers + 1 LstmSeq passes and its backward as many;
    the log-probs (1e-4, as tests/test_torch_model.py) and the gradient of
    every parameter of a weighted sum of them (atol 1e-4 / rtol 1e-3)
    equal mdd_tpu's (Pallas kernels in interpret mode, its text scan)."""
    calls = _count_lstm_seq(monkeypatch)
    kw = dict(SMALL, use_pallas_lstm=True)
    jmodel = JaxModel(JaxConfig(**kw))
    variables = jmodel.init(jax.random.key(0),
                            np.zeros((1, 16, 243), np.float32),
                            np.zeros((1, 4), np.int32),
                            np.asarray([4], np.int32))
    rng = np.random.default_rng(0)
    params = _perturbed(variables["params"], rng)
    stats = _perturbed(variables["batch_stats"], rng)
    feats, trans, lengths = _inputs(1)
    tmodel = CTCAttentionModel(ModelConfig(**kw))
    tmodel.load_state_dict(flax_to_torch(params, stats), strict=True)
    tmodel.eval()
    assert tmodel.text.lstm.rnn is lstm_cuda.bilstm_cuda
    weights = rng.standard_normal((12, 3, 12)).astype(np.float32)

    def loss_j(p):
        out = jmodel.apply({"params": p, "batch_stats": stats}, feats, trans,
                           lengths, train=False)
        return jnp.sum(out * weights), out

    (_, ref), grads = jax.value_and_grad(loss_j, has_aux=True)(params)
    out = tmodel(torch.from_numpy(feats), torch.from_numpy(trans).long(),
                 torch.from_numpy(lengths).long())
    assert calls == {"fwd": kw["rnn_layers"] + 1, "bwd": 0}
    (out * torch.from_numpy(weights)).sum().backward()
    assert calls == {"fwd": kw["rnn_layers"] + 1,
                     "bwd": kw["rnn_layers"] + 1}
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-4)
    want = flax_to_torch(jax.device_get(grads), stats)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("dtype,use_pallas_lstm,route", [
    ("bfloat16", True, "scan"), ("float32", False, "plain"),
    ("bfloat16", False, "plain"), ("float32", True, "kernel")])
def test_text_route_is_fixed_by_the_configuration(monkeypatch, dtype,
                                                  use_pallas_lstm, route):
    """use_pallas_lstm puts the text BiLSTM on the kernels: in float32
    those of the Pallas contract (LstmSeq), in bfloat16 those of the scan
    contract (LstmScan), which round h and c every step as mdd_tpu's text
    scan does; without it the plain loop.  The acoustic layers follow
    use_pallas_lstm alone."""
    calls = _count_lstm_seq(monkeypatch)
    scan = {"fwd": 0}
    scan_fwd = lstm_cuda.lstm_scan_fwd

    def counted_scan_fwd(*a):
        scan["fwd"] += 1
        return scan_fwd(*a)

    monkeypatch.setattr(lstm_cuda, "lstm_scan_fwd", counted_scan_fwd)
    cfg = ModelConfig(**SMALL, use_pallas_lstm=use_pallas_lstm,
                      compute_dtype=dtype)
    model = CTCAttentionModel(cfg)
    model.init_parameters(torch.Generator().manual_seed(0))
    want = {"kernel": lstm_cuda.bilstm_cuda, "plain": bilstm,
            "scan": lstm_cuda.bilstm_scan_cuda}[route]
    assert model.text.lstm.rnn is want
    feats, trans, lengths = _inputs(2)
    with torch.inference_mode():
        out = model(torch.from_numpy(feats), torch.from_numpy(trans).long(),
                    torch.from_numpy(lengths).long())
    assert torch.isfinite(out).all()
    acoustic = cfg.rnn_layers if use_pallas_lstm else 0
    assert calls["fwd"] == acoustic + (route == "kernel")
    assert scan["fwd"] == (route == "scan")
