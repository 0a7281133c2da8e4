"""The port's training path vs mdd_tpu's on the same numpy inputs: masked
train-mode BatchNorm against flax's, the CTC loss and its gradient at the
logits, the device WER counts, the device splice, the plateau machine,
and one whole train step at a small width (dropout 0) from the same
weights and batch.  Forward values at 1e-5, gradients and updated
parameters at atol 1e-4 / rtol 1e-3 (float32, sums in another order)."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mdd_tpu.data.dataset import Batch as JaxBatch
from mdd_tpu.frontend.splice import batched_splice_skip as jax_splice
from mdd_tpu.models.ctc_model import ModelConfig as JaxConfig
from mdd_tpu.ops.ctc_loss import ctc_loss as jax_ctc_loss
from mdd_tpu.ops.ctc_loss import ctc_loss_sum_mean as jax_ctc_sum_mean
from mdd_tpu.ops import wer as jax_wer
from mdd_tpu.train.loop import Trainer as JaxTrainer
from mdd_tpu_torch.convert import flax_to_torch, random_flax_variables
from mdd_tpu_torch.data.dataset import BucketedLoader, SpeechDataset
from mdd_tpu_torch.data.dataset import pad_batch_to
from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.frontend.splice import batched_splice_skip
from mdd_tpu_torch.models.ctc_model import BatchNorm, ModelConfig
from mdd_tpu_torch.ops import ctc_loss, wer, wer_cuda
from mdd_tpu_torch.train.loop import Trainer
from mdd_tpu_torch.train.plateau import PlateauAction, PlateauScheduler
from test_torch_data import UNITS, write_corpus

GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


# ---------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("layout", ["btd", "conv"])
def test_masked_train_batchnorm_matches_flax(layout):
    """Output and updated running statistics, with two rows masked out of
    the statistics (and given wild values that must not leak in)."""
    rng = np.random.default_rng(0)
    feats = 6
    shape = (5, 7, feats) if layout == "btd" else (5, 7, 3, feats)   # NHWC
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    x[3:] = 50.0 * rng.standard_normal(x[3:].shape)
    mask = np.array([True, True, True, False, False])
    scale, bias = (rng.uniform(0.5, 1.5, feats).astype(np.float32),
                   rng.standard_normal(feats).astype(np.float32))
    mean, var = (rng.standard_normal(feats).astype(np.float32),
                 rng.uniform(0.5, 2, feats).astype(np.float32))
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    jmask = mask.reshape((5,) + (1,) * (len(shape) - 1))
    y_j, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                         "batch_stats": {"mean": mean, "var": var}},
                        x, mask=jmask, mutable=["batch_stats"])
    port = BatchNorm(feats)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          dict(scale=scale, bias=bias, mean=mean,
                               var=var).items()})
    xt = torch.from_numpy(x)
    axis = -1
    if layout == "conv":                       # the port's convs are NCHW
        xt, axis = xt.permute(0, 3, 1, 2), 1
    y_t = port(xt, torch.float32, axis=axis, train=True,
               sample_mask=torch.from_numpy(mask))
    if layout == "conv":
        y_t = y_t.permute(0, 2, 3, 1)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               atol=1e-5, rtol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(port, k).numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- CTC loss
def _ctc_inputs(seed):
    rng = np.random.default_rng(seed)
    t, b, c, l = 12, 5, 7, 5
    logits = rng.standard_normal((t, b, c)).astype(np.float32) * 2
    labels = rng.integers(1, c, (b, l)).astype(np.int32)
    labels[2, :4] = [3, 3, 3, 3]          # 4 labels + 3 repeats: 7 frames
    label_lengths = np.array([5, 3, 4, 0, 2], np.int32)
    input_lengths = np.array([12, 9, 6, 4, 12], np.int32)   # row 2 cannot fit
    return logits, input_lengths, labels, label_lengths


def test_ctc_loss_and_logit_gradients_match_jax():
    logits, il, labels, ll = _ctc_inputs(0)
    w = np.linspace(0.5, 1.5, logits.shape[1]).astype(np.float32)

    def loss_j(lg):
        nll = jax_ctc_loss(jax.nn.log_softmax(lg, -1), il, labels, ll)
        return jnp.sum(jnp.where(nll < 1e29, nll, 0.0) * w), nll

    (_, nll_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    nll_t = ctc_loss.ctc_loss(torch.log_softmax(lg, -1), torch.from_numpy(il),
                              torch.from_numpy(labels), torch.from_numpy(ll))
    (torch.where(nll_t < 1e29, nll_t, 0.0) * torch.from_numpy(w)).sum(
        ).backward()
    assert nll_t[2].item() == float(nll_j[2]) == np.float32(1e30)
    np.testing.assert_allclose(nll_t.detach().numpy(), np.asarray(nll_j),
                               rtol=1e-5)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(g_j), **GRAD_TOL)
    assert not lg.grad[:, 2].any()          # infeasible: zero gradient


def test_ctc_loss_sum_mean_matches_jax():
    logits, il, labels, ll = _ctc_inputs(1)
    il[2] = 12                               # every row feasible
    lp = jax.nn.log_softmax(jnp.asarray(logits), -1)
    ref = jax_ctc_sum_mean(lp, il, labels, ll)
    out = ctc_loss.ctc_loss_sum_mean(torch.from_numpy(np.array(lp)),
                                     torch.from_numpy(il),
                                     torch.from_numpy(labels),
                                     torch.from_numpy(ll))
    assert out.item() == pytest.approx(float(ref), rel=1e-5)


# ---------------------------------------------------------------- WER, splice
def test_greedy_wer_counts_match_jax():
    rng = np.random.default_rng(3)
    b, t, l = 6, 20, 7
    ids = rng.integers(0, 5, (b, t)).astype(np.int32)
    frames = rng.integers(0, t + 1, b).astype(np.int32)
    targets = rng.integers(1, 5, (b, l)).astype(np.int32)
    tsizes = rng.integers(0, l + 1, b).astype(np.int32)
    valid = np.array([1, 1, 0, 1, 1, 0], bool)
    ref = jax_wer.greedy_wer_counts(ids, frames, targets, tsizes, valid)
    out = wer.greedy_wer_counts(*(torch.from_numpy(a) for a in
                                  (ids, frames, targets, tsizes, valid)))
    assert [int(v) for v in out] == [int(v) for v in ref]
    dist_j = jax_wer.batched_edit_distance(ids, frames, targets, tsizes)
    dist_t = wer.batched_edit_distance(*(torch.from_numpy(a) for a in
                                         (ids, frames, targets, tsizes)))
    np.testing.assert_array_equal(dist_t.numpy(), np.asarray(dist_j))


def _wer_case(case: str):
    """(ids, frames, targets, target_sizes, valid) numpy at the shape of
    test_greedy_wer_counts_match_jax (one compile of mdd_tpu's scan)."""
    rng = np.random.default_rng(5)
    b, t, l = 6, 20, 7
    ids = rng.integers(0, 5, (b, t)).astype(np.int64)
    frames = rng.integers(1, t + 1, b).astype(np.int64)
    targets = rng.integers(1, 5, (b, l)).astype(np.int64)
    tsizes = rng.integers(0, l + 1, b).astype(np.int64)
    valid = np.array([1, 1, 0, 1, 1, 1], bool)
    if case == "no-frames":
        frames[:3] = 0
    if case == "no-targets":
        tsizes[:3] = 0
    if case == "all-blank":
        ids[:3] = 0
    if case == "frames-past-the-width":
        frames[:] = t + 5
    return ids, frames, targets, tsizes, valid


@pytest.mark.parametrize("case", ["random", "no-frames", "no-targets",
                                  "all-blank", "frames-past-the-width",
                                  "transposed-ids"])
def test_greedy_wer_sends_cpu_tensors_to_the_plain_version(case,
                                                           monkeypatch):
    """The train step's WER dispatcher on CPU tensors: the plain loop, no
    launch, and mdd_tpu's counts (the transposed ids are the step's
    argmax(-1).transpose(0, 1))."""
    def refuse(*_, **__):
        raise AssertionError("a CPU tensor reached the WER kernel")
    monkeypatch.setattr(wer_cuda, "greedy_wer_kernel", refuse)
    arrays = _wer_case("random" if case == "transposed-ids" else case)
    ref = jax_wer.greedy_wer_counts(*arrays)
    args = [torch.from_numpy(a) for a in arrays]
    if case == "transposed-ids":
        args[0] = args[0].t().contiguous().t()
    out = wer_cuda.greedy_wer(*args)
    assert [int(v) for v in out] == [int(v) for v in ref]


_GOOD_WER = dict(ids=torch.zeros((3, 5), dtype=torch.int64),
                 frames=torch.ones(3, dtype=torch.int64),
                 targets=torch.ones((3, 4), dtype=torch.int64),
                 target_sizes=torch.ones(3, dtype=torch.int64),
                 valid=torch.ones(3, dtype=torch.bool))


@pytest.mark.parametrize("bad,error,match", [
    (dict(ids=torch.zeros((3, 5), dtype=torch.int32)), TypeError, "ids"),
    (dict(frames=torch.ones(3)), TypeError, "frames"),
    (dict(valid=torch.ones(3, dtype=torch.int64)), TypeError, "valid"),
    (dict(targets=torch.ones(4, dtype=torch.int64)), ValueError, "2-D"),
    (dict(targets=torch.ones((3, 1024), dtype=torch.int64)), ValueError,
     "1023"),
    (dict(frames=torch.ones((3, 2), dtype=torch.int64)[:, 0]), ValueError,
     "contiguous"),
    (dict(target_sizes=torch.ones(4, dtype=torch.int64)), ValueError,
     "batch size"),
    (dict(ids=torch.zeros((0, 5), dtype=torch.int64),
          frames=torch.ones(0, dtype=torch.int64)), ValueError, "one row"),
    ({}, ValueError, "CUDA tensors"),
])
def test_wer_kernel_wrapper_refuses_on_the_cpu(bad, error, match):
    """Every refusal of the kernel's wrapper shows on CPU tensors, before
    any build or launch (the device is checked last)."""
    kernel = wer_cuda.GreedyWerKernel()
    with pytest.raises(error, match=match):
        kernel(**{**_GOOD_WER, **bad})
    assert kernel.launches == 0 and kernel._lib is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_splice_skip_matches_jax(dtype):
    rng = np.random.default_rng(4)
    b, t_raw, d = 4, 24, 5
    lengths = np.array([24, 17, 1, 0], np.int32)
    raw = rng.standard_normal((b, t_raw, d)).astype(np.float32)
    raw *= (np.arange(t_raw)[None] < lengths[:, None])[..., None]
    jraw = jnp.asarray(raw, dtype)
    ref, frames_j = jax_splice(jraw, lengths, 1, 2, 2, 2)
    out, frames_t = batched_splice_skip(
        torch.from_numpy(raw).to(getattr(torch, dtype)),
        torch.from_numpy(lengths), 1, 2, 2, 2)
    assert out.dtype == getattr(torch, dtype)
    assert (out.float().numpy().tobytes()
            == np.asarray(ref, np.float32).tobytes())
    np.testing.assert_array_equal(frames_t.numpy(), np.asarray(frames_j))


# ---------------------------------------------------------------- plateau
def test_plateau_machine_reference_semantics():
    """The sequence of tests/test_train.py, on the port's scheduler."""
    s = PlateauScheduler(init_lr=1.0, decay=0.5, end_adjust_acc=2.0,
                         patience=3, max_adjust_times=2)
    a = s.step(100.0, 0.1)
    assert a & PlateauAction.SNAPSHOT_LOSS and s.adjust_rate_count == 0
    a = s.step(101.0, 0.1)
    assert (s.adjust_rate_count == 1
            and not (a & PlateauAction.DECAY_AND_RESTORE))
    s.step(100.5, 0.1)
    a = s.step(101.5, 0.1)
    assert a & PlateauAction.DECAY_AND_RESTORE
    assert s.learning_rate == 0.5 and s.adjust_time == 1
    a = s.step(99.0, 0.2)
    assert a & PlateauAction.SNAPSHOT_LOSS and a & PlateauAction.SNAPSHOT_ACC
    a = s.step(200.0, 0.1)
    assert a & PlateauAction.DECAY_AND_RESTORE
    assert a & PlateauAction.STOP and s.stopped
    assert s.learning_rate == 0.25


# ---------------------------------------------------------------- one step
SMALL = dict(input_dim=243, num_class=len(UNITS) + 2, conv_channels=(4, 4),
             rnn_hidden_size=16, rnn_layers=2, text_embed_size=8,
             text_vocab_size=16, dropout=0.0, use_pallas_lstm=True)


@pytest.fixture(scope="module")
def step_batch(tmp_path_factory):
    """A 4-row train batch of the tiny corpus (raw features, device front
    end) padded to 6 rows: two mask rows."""
    corpus = write_corpus(tmp_path_factory.mktemp("step"), "train", 4,
                          seed=3, frames=(6, 10))
    ds = SpeechDataset(Vocab(UNITS), *corpus, train=True, mutation_prob=0.2,
                       device_frontend=True)
    batch = next(iter(BucketedLoader(ds, 4, seed=1, time_quantum=8,
                                     label_quantum=4)))
    return pad_batch_to(batch, 6)


@pytest.mark.parametrize("device_frontend", [True, False])
def test_one_train_step_matches_jax(step_batch, device_frontend):
    """From the same weights and batch: the loss, the WER counts, the
    gradient of every parameter (through each Trainer's own loss
    function), the new BN statistics, and every parameter after one step
    of each Trainer's optimizer (Adam, lr 1e-3, coupled L2 5e-4)."""
    padded, valid = step_batch
    if not device_frontend:          # host-spliced rows of the same batch
        from mdd_tpu_torch.frontend.splice import make_context, skip_frames
        rows = [skip_frames(make_context(x, 0, 2), 2) for x in padded.inputs]
        padded = dataclasses.replace(padded, inputs=np.stack(rows))
    cfg = dict(SMALL)
    params, stats = random_flax_variables(ModelConfig(**cfg), seed=2)
    kw = dict(init_lr=1e-3, weight_decay=5e-4, seed=0,
              device_frontend=device_frontend)

    # mdd_tpu's step, unrolled so that its gradients can be read: the
    # Trainer's own loss function under value_and_grad, then its optimizer
    jt = JaxTrainer(JaxConfig(**cfg), n_devices=1, **kw)
    jparams, jstats = jax.tree.map(jnp.asarray, (params, stats))
    jbatch = JaxBatch(np.asarray(padded.inputs), padded.input_fracs,
                      padded.targets, padded.target_sizes, padded.trans,
                      padded.trans_sizes, padded.utt_ids)
    arrays = jt._batch_arrays(jbatch, valid)
    (loss_j, (stats_j, errs_j, tokens_j)), grads_j = jax.jit(
        jax.value_and_grad(lambda p: jt._loss_and_out(
            p, jstats, arrays, jax.random.key(0), True), has_aux=True))(
                jparams)
    opt = jt.optimizer(learning_rate=1e-3)
    updates, opt_state = opt.update(grads_j, opt.init(jparams), jparams)
    params_j = optax.apply_updates(jparams, updates)
    adam_j = next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    mu_j = flax_to_torch(jax.device_get(adam_j.mu), stats)
    nu_j = flax_to_torch(jax.device_get(adam_j.nu), stats)

    pt = Trainer(ModelConfig(**cfg), device="cpu", **kw)
    pt.model.load_state_dict(flax_to_torch(params, stats), strict=True)
    before = {k: v.clone() for k, v in pt.model.state_dict().items()}
    acc_t = pt.train_step(pt.batch_arrays(padded, valid), torch.zeros(4))

    assert acc_t[0].item() == pytest.approx(float(loss_j), rel=1e-5)
    assert acc_t[0].item() < 1e29                     # every row feasible
    assert acc_t[1:].tolist() == [int(errs_j), int(tokens_j), 1]
    g_j = flax_to_torch(jax.device_get(grads_j), stats)
    want = flax_to_torch(jax.device_get(params_j), jax.device_get(stats_j))
    got = pt.model.state_dict()
    assert got.keys() == want.keys()
    b1, b2, eps = 0.9, 0.999, 1e-8
    for name, p in pt.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), g_j[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
        # Adam's moments after one step are (1 - b1) g and (1 - b2) g^2 of
        # the decayed gradient g + wd * p: held against optax's, as g
        m = pt.optimizer.state[p]["exp_avg"].numpy()
        v = pt.optimizer.state[p]["exp_avg_sq"].numpy()
        g = p.grad.numpy() + 5e-4 * before[name].numpy()
        np.testing.assert_allclose(m / (1 - b1), mu_j[name].numpy() / (1 - b1),
                                   err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(np.sqrt(v / (1 - b2)),
                                   np.sqrt(nu_j[name].numpy() / (1 - b2)),
                                   err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(m / (1 - b1), g, rtol=1e-5, atol=0,
                                   err_msg=name)
        # every entry moved by Adam's step on those moments, which is
        # lr * g / (|g| + eps), about lr * sign(g) ...
        step = got[name].numpy() - before[name].numpy()
        want_step = -1e-3 * (m / (1 - b1)) / (np.sqrt(v / (1 - b2)) + eps)
        np.testing.assert_allclose(step, want_step, rtol=1e-4, atol=1e-9,
                                   err_msg=name)
        assert np.all(np.sign(step) == -np.sign(g)), name
        # ... and equals optax's where g is clear of the gradients' rounding
        # (nearer 0 its sign, and so the step, is not determined)
        sure = np.abs(g) > 1e-3
        np.testing.assert_allclose(got[name].numpy()[sure],
                                   want[name].numpy()[sure], err_msg=name,
                                   **GRAD_TOL)
    for name, _ in pt.model.named_buffers():
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
