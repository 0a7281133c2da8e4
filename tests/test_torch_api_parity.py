"""The last public names of mdd_tpu that the port lacked, against
mdd_tpu's on the same numpy inputs on the CPU: `greedy_decode` (the same
ids), `Vocab.from_label_file` / `encode_array` / `units` / `save_units`
(the same vocabulary, int32 array and file bytes), `ctc_loss_scan` (the
loss within 1e-5 and the gradient within 1e-4 / rtol 1e-3 of mdd_tpu's
`ctc_loss_scan` and of the port's `ctc_loss`; an infeasible row's loss
equal within rtol 1e-6) and `make_optimizer` (Adam with coupled L2, step
by step against mdd_tpu's optax chain, and the one the Trainer builds)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mdd_tpu.data.vocab import Vocab as JaxVocab
from mdd_tpu.decode.greedy import greedy_decode as jax_greedy_decode
from mdd_tpu.ops.ctc_loss import ctc_loss_scan as jax_ctc_loss_scan
from mdd_tpu.train.loop import make_optimizer as jax_make_optimizer
from mdd_tpu_torch import decode
from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.decode.greedy import best_path, collapse_ctc, greedy_decode
from mdd_tpu_torch.models.ctc_model import ModelConfig
from mdd_tpu_torch.ops.ctc_loss import LOG_EPS, ctc_loss, ctc_loss_scan
from mdd_tpu_torch.train import loop


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_decode_matches_mdd_tpu(seed):
    """Frames repeated in runs of 1-3, so repeats and blanks between
    equal labels both occur; ragged lengths, one of 0 frames."""
    rng = np.random.default_rng(seed)
    t, b, c = 36, 6, 7
    runs = rng.integers(1, 4, t)
    logits = np.repeat(rng.standard_normal((t, b, c)), runs, axis=0)[:t]
    logits[..., 0] += 0.5
    log_probs = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))
                 ).astype(np.float32)
    lengths = rng.integers(1, t + 1, b)
    lengths[0] = 0
    want = jax_greedy_decode(log_probs, lengths)
    assert greedy_decode(torch.from_numpy(log_probs), lengths) == want
    assert greedy_decode(log_probs, lengths.tolist()) == want
    ids = best_path(torch.from_numpy(log_probs))
    assert [collapse_ctc(ids[i], int(lengths[i])) for i in range(b)] == want
    assert decode.greedy_decode is greedy_decode


def test_vocab_label_file_array_units_and_file_match_mdd_tpu(tmp_path):
    rng = np.random.default_rng(0)
    phones = ["sil", "aa", "bb", "cc", "dd", "ee", "err"]
    path = tmp_path / "phn_text"
    path.write_text("".join(
        f"utt{i} " + " ".join(rng.choice(phones, rng.integers(1, 9))) + "\n"
        for i in range(40)))
    ours, theirs = Vocab.from_label_file(str(path)), JaxVocab.from_label_file(
        str(path))
    assert ours.word2index == theirs.word2index
    assert ours.index2word == theirs.index2word
    assert ours.word2count == theirs.word2count
    assert ours.units() == theirs.units()
    probe = list(rng.choice(phones, 20)) + ["zz", "blank", "UNK"]
    got, want = ours.encode_array(probe), theirs.encode_array(probe)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    ours.save_units(str(tmp_path / "ours"))
    theirs.save_units(str(tmp_path / "theirs"))
    assert ((tmp_path / "ours").read_bytes()
            == (tmp_path / "theirs").read_bytes())
    assert Vocab.from_units_file(str(tmp_path / "ours")).word2index == \
        ours.word2index


def _ctc_case(seed):
    """(T, B, C) logits and labels with ragged lengths: row 1 has no label,
    row 2 repeats a label, row 3 cannot fit its labels (infeasible)."""
    rng = np.random.default_rng(seed)
    t, b, c, l = 14, 5, 6, 5
    logits = rng.standard_normal((t, b, c)).astype(np.float32)
    labels = rng.integers(1, c, (b, l)).astype(np.int32)
    labels[2, 1] = labels[2, 0]
    label_lengths = np.array([5, 0, 4, 5, 3], np.int32)
    input_lengths = np.array([14, 9, 12, 4, 11], np.int32)
    return logits, labels, input_lengths, label_lengths


INFEASIBLE = 3


def _jax_scan(logits, labels, input_lengths, label_lengths, weights):
    """mdd_tpu's ctc_loss_scan: nll and d(sum w * nll)/d log_probs."""
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    args = (jnp.asarray(input_lengths), jnp.asarray(labels),
            jnp.asarray(label_lengths))
    nll = jax_ctc_loss_scan(lp, *args)
    grad = jax.grad(lambda x: jnp.sum(
        jax_ctc_loss_scan(x, *args) * weights))(lp)
    return np.asarray(lp), np.asarray(nll), np.asarray(grad)


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_loss_scan_matches_mdd_tpu_scan(seed):
    logits, labels, input_lengths, label_lengths = _ctc_case(seed)
    weights = np.linspace(0.5, 1.5, logits.shape[1]).astype(np.float32)
    lp_np, want_nll, want_grad = _jax_scan(logits, labels, input_lengths,
                                           label_lengths, weights)
    lp = torch.from_numpy(lp_np.copy()).requires_grad_(True)
    nll = ctc_loss_scan(lp, torch.from_numpy(input_lengths),
                        torch.from_numpy(labels),
                        torch.from_numpy(label_lengths))
    (nll * torch.from_numpy(weights)).sum().backward()
    got = nll.detach().numpy()
    feasible = np.arange(len(got)) != INFEASIBLE
    assert want_nll[INFEASIBLE] == pytest.approx(-LOG_EPS)
    np.testing.assert_allclose(got[feasible], want_nll[feasible], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[INFEASIBLE], want_nll[INFEASIBLE],
                               rtol=1e-6)
    np.testing.assert_allclose(lp.grad.numpy(), want_grad, rtol=1e-3,
                               atol=1e-4)
    assert not lp.grad[:, INFEASIBLE].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_loss_scan_matches_the_ports_ctc_loss(seed):
    """Against the port's `ctc_loss` (mdd_tpu's custom VJP, on CPU tensors
    the plain versions of its kernels): the same losses (1e30 on the
    infeasible row), the same gradient at the logits."""
    logits, labels, input_lengths, label_lengths = _ctc_case(seed)
    args = (torch.from_numpy(input_lengths), torch.from_numpy(labels),
            torch.from_numpy(label_lengths))
    grads, losses = [], []
    for fn in (ctc_loss_scan, ctc_loss):
        x = torch.from_numpy(logits).requires_grad_(True)
        nll = fn(torch.log_softmax(x, dim=-1), *args)
        feasible = torch.arange(len(nll)) != INFEASIBLE
        (nll * feasible).sum().backward()
        grads.append(x.grad.numpy())
        losses.append(nll.detach().numpy())
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-3, atol=1e-4)


def test_make_optimizer_steps_as_mdd_tpu():
    """Three Adam steps with coupled L2 (lr 1e-3, weight decay 5e-4) on
    the same parameters and gradients."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(np.float32)
             for _ in range(3)]
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = loop.make_optimizer([param], 1e-3, 5e-4)
    tx = jax_make_optimizer(5e-4)(learning_rate=1e-3)
    params = jnp.asarray(p0)
    state = tx.init(params)
    for g in grads:
        param.grad = torch.from_numpy(g)
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        np.testing.assert_allclose(param.detach().numpy(),
                                   np.asarray(params), rtol=1e-6, atol=1e-7)


def test_trainer_builds_its_optimizer_with_make_optimizer(monkeypatch):
    calls = []
    real = loop.make_optimizer

    def spy(params, lr, weight_decay):
        calls.append((lr, weight_decay))
        return real(params, lr, weight_decay)

    monkeypatch.setattr(loop, "make_optimizer", spy)
    cfg = ModelConfig(rnn_hidden_size=16, rnn_layers=1, conv_channels=(2, 2),
                      text_embed_size=8)
    trainer = loop.Trainer(cfg, init_lr=2e-3, weight_decay=1e-4,
                           device="cpu")
    assert calls == [(2e-3, 1e-4)]
    assert isinstance(trainer.optimizer, torch.optim.Adam)
    group = trainer.optimizer.param_groups[0]
    assert (group["lr"], group["weight_decay"]) == (2e-3, 1e-4)
    assert len(group["params"]) == len(list(trainer.model.parameters()))
