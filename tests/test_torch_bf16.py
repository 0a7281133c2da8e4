"""compute_dtype "bfloat16" (the dtype of the shipped recipes): the port
against mdd_tpu on the same numpy inputs and weights at a small width, in
eval mode (log-probs) and in train mode at dropout 0 (the loss and every
parameter's gradient through each package's own loss function).  Both
packages also run the same case in float32.

bfloat16 rounds at other places in two frameworks unless told not to, so
no fixed tolerance says what "the same" is.  Each comparison is held to a
multiple k of what bfloat16 itself moves: for every tensor

    max |port_bf16 - jax_bf16|
        <= k * max(max |jax_bf16 - jax_f32|, max |port_bf16 - port_f32|)
           + 1e-6 * max |jax_f32|

the deviation between the packages within k times the larger deviation of
either package from its own float32 result, plus a floor for tensors that
bfloat16 happens to leave unchanged; k = 0.1 throughout.  Both packages
then round every op's result to its declared dtype: PyTorch does so op by
op, mdd_tpu's eval forward runs op by op too, and its jitted train loss
and gradients are compiled with XLA's `xla_allow_excess_precision` off
(on, which is XLA's default, a fusion may keep float32 where the program
says bfloat16, and the packages then differ by 1-2 times bfloat16's own
deviation).  Measured on the CPU: eval log-probs agree to ~1e-7 while
bfloat16 moves them by ~2e-2, train losses and gradients to at most 0.001
of bfloat16's own deviation, with 1 thread as with 8.  A port that rounds
at a wrong place moves further: the BiLSTM's c carried in float32
instead of bfloat16 moves the log-probs by 1.7 times bfloat16's own
deviation and the train loss by 0.7-1.4 times; a conv bias added inside
the product (one rounding, where flax's Conv rounds the product and then
the sum) moves the train loss by 1.1 times; dgates left unrounded in the
fused LSTM's backward move the gradients by up to 0.28 times.

The conv biases are held apart: they feed a train-mode BatchNorm, which
subtracts the batch mean, so their gradient is 0 up to rounding; in
float32 both packages must give ~0, in bfloat16 both are noise of
different sizes (bfloat16 sums of ~20,000 terms) and are only held finite.

The acoustic recurrence runs on both paths: the plain scan
(`use_pallas_lstm=False`; h and c carried in the compute dtype) and the
fused one (`True`; mdd_tpu's Pallas kernels in interpret mode, the port's
plain versions of its CUDA kernels, c in float32).

    python -m pytest tests/test_torch_bf16.py -q
"""

import jax
import numpy as np
import pytest
import torch

from mdd_tpu.data.dataset import Batch as JaxBatch
from mdd_tpu.models.ctc_model import CTCAttentionModel as JaxModel
from mdd_tpu.models.ctc_model import ModelConfig as JaxConfig
from mdd_tpu.train.loop import Trainer as JaxTrainer
from mdd_tpu_torch.convert import flax_to_torch, random_flax_variables
from mdd_tpu_torch.data.dataset import BucketedLoader, SpeechDataset
from mdd_tpu_torch.data.dataset import pad_batch_to
from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.models.ctc_model import CTCAttentionModel, ModelConfig
from mdd_tpu_torch.train.loop import Trainer
from test_torch_data import UNITS, write_corpus
from test_torch_model import SMALL, _inputs, _perturbed

DTYPES = ("float32", "bfloat16")
K = 0.1
#: XLA rounds every op's result to its declared dtype, as PyTorch does
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}


def assert_bf16_close(port: dict, jax_: dict, name: str, k: float) -> None:
    """port, jax_: {"float32": array, "bfloat16": array} of one tensor; the
    rule of the module docstring with multiple k."""
    p32, p16 = (np.asarray(port[d], np.float32) for d in DTYPES)
    j32, j16 = (np.asarray(jax_[d], np.float32) for d in DTYPES)
    own = max(np.abs(j16 - j32).max(), np.abs(p16 - p32).max())
    limit = k * own + 1e-6 * np.abs(j32).max()
    dev = np.abs(p16 - j16).max()
    assert dev <= limit, (f"{name}: port and mdd_tpu differ by {dev:.3e} in "
                          f"bfloat16, limit {limit:.3e} (each package's own "
                          f"bfloat16 deviation at most {own:.3e})")


@pytest.mark.parametrize("use_pallas_lstm", [False, True])
def test_eval_log_probs_match_jax_in_bfloat16(use_pallas_lstm):
    """(T', B, C) log-probs of the same perturbed weights and inputs."""
    feats, trans, lengths = _inputs(1)
    out = {"port": {}, "jax": {}}
    for dtype in DTYPES:
        kw = dict(SMALL, use_pallas_lstm=use_pallas_lstm,
                  compute_dtype=dtype)
        jmodel = JaxModel(JaxConfig(**kw))
        variables = jmodel.init(jax.random.key(0),
                                np.zeros((1, 16, 243), np.float32),
                                np.zeros((1, 4), np.int32),
                                np.asarray([4], np.int32))
        rng = np.random.default_rng(0)
        params = _perturbed(variables["params"], rng)
        stats = _perturbed(variables["batch_stats"], rng)
        tmodel = CTCAttentionModel(ModelConfig(**kw))
        tmodel.load_state_dict(flax_to_torch(params, stats), strict=True)
        tmodel.eval()
        out["jax"][dtype] = jmodel.apply(
            {"params": params, "batch_stats": stats}, feats, trans, lengths,
            train=False)
        with torch.inference_mode():
            lp = tmodel(torch.from_numpy(feats),
                        torch.from_numpy(trans).long(),
                        torch.from_numpy(lengths).long())
        assert lp.dtype == torch.float32 and torch.isfinite(lp).all()
        out["port"][dtype] = lp.numpy()
    # bfloat16 really ran: the log-probs moved
    assert np.abs(out["port"]["bfloat16"] - out["port"]["float32"]).max() > 1e-3
    assert_bf16_close(out["port"], out["jax"], "log-probs", k=K)


@pytest.fixture(scope="module")
def train_batch(tmp_path_factory):
    """A 4-row train batch of the tiny corpus (raw features, device front
    end) padded to 6 rows: two mask rows."""
    corpus = write_corpus(tmp_path_factory.mktemp("bf16"), "train", 4,
                          seed=5, frames=(6, 10))
    ds = SpeechDataset(Vocab(UNITS), *corpus, train=True, mutation_prob=0.2,
                       device_frontend=True)
    batch = next(iter(BucketedLoader(ds, 4, seed=2, time_quantum=8,
                                     label_quantum=4)))
    return pad_batch_to(batch, 6)


def _train_cfg(use_pallas_lstm, dtype):
    return dict(input_dim=243, num_class=len(UNITS) + 2,
                conv_channels=(4, 4), rnn_hidden_size=16, rnn_layers=2,
                text_embed_size=8, text_vocab_size=16, dropout=0.0,
                use_pallas_lstm=use_pallas_lstm, compute_dtype=dtype)


@pytest.mark.parametrize("use_pallas_lstm", [False, True])
def test_train_loss_and_gradients_match_jax_in_bfloat16(train_batch,
                                                        use_pallas_lstm):
    """Train mode at dropout 0 from the same float32 weights and batch: the
    loss and the gradient of every parameter, each package through its own
    Trainer's loss function."""
    padded, valid = train_batch
    params, stats = random_flax_variables(
        ModelConfig(**_train_cfg(use_pallas_lstm, "float32")), seed=3)
    kw = dict(init_lr=1e-3, weight_decay=5e-4, seed=0, device_frontend=True)
    loss = {"port": {}, "jax": {}}
    grads = {"port": {}, "jax": {}}
    for dtype in DTYPES:
        cfg = _train_cfg(use_pallas_lstm, dtype)
        jt = JaxTrainer(JaxConfig(**cfg), n_devices=1, **kw)
        jbatch = JaxBatch(np.asarray(padded.inputs), padded.input_fracs,
                          padded.targets, padded.target_sizes, padded.trans,
                          padded.trans_sizes, padded.utt_ids)
        arrays = jt._batch_arrays(jbatch, valid)
        jparams, jstats = jax.tree.map(jax.numpy.asarray, (params, stats))
        loss_and_grad = jax.jit(jax.value_and_grad(
            lambda p: jt._loss_and_out(p, jstats, arrays, jax.random.key(0),
                                       True), has_aux=True))
        (loss_j, _), grads_j = loss_and_grad.lower(jparams).compile(
            compiler_options=NO_EXCESS_PRECISION)(jparams)
        loss["jax"][dtype] = float(loss_j)
        grads["jax"][dtype] = flax_to_torch(jax.device_get(grads_j), stats)

        pt = Trainer(ModelConfig(**cfg), device="cpu", **kw)
        pt.model.load_state_dict(flax_to_torch(params, stats), strict=True)
        loss_t, _, _ = pt._loss_and_out(pt.batch_arrays(padded, valid),
                                        train=True)
        loss_t.backward()
        assert np.isfinite(loss_t.item()) and loss_t.item() < 1e29
        loss["port"][dtype] = loss_t.item()
        grads["port"][dtype] = {n: p.grad for n, p in
                                pt.model.named_parameters()}
    assert loss["port"]["bfloat16"] != loss["port"]["float32"]
    assert_bf16_close(loss["port"], loss["jax"], "loss", k=K)
    # the parameters (flax_to_torch also maps the statistics' cotangents)
    names = list(grads["port"]["float32"])
    assert len(names) > 20 and set(names) <= set(grads["jax"]["float32"])
    port = {n: {d: grads["port"][d][n].float().numpy() for d in DTYPES}
            for n in names}
    jax_ = {n: {d: grads["jax"][d][n].numpy() for d in DTYPES} for n in names}
    largest = max(np.abs(jax_[n]["float32"]).max() for n in names)
    zero = [n for n in names if n.startswith("conv.conv") and
            n.endswith(".bias")]
    assert len(zero) == 2
    for name in names:
        if name in zero:           # 0 up to rounding (module docstring)
            for pkg in (port, jax_):
                assert np.abs(pkg[name]["float32"]).max() <= 1e-5 * largest
                assert np.isfinite(pkg[name]["bfloat16"]).all()
        else:
            assert_bf16_close(port[name], jax_[name], f"gradient of {name}",
                              k=K)
