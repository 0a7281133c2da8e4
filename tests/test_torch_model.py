"""Port CTCAttentionModel vs mdd_tpu's at a small width: weights initialised
in JAX, bridged with convert.flax_to_torch, log-probs compared."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdd_tpu.models.ctc_model import CTCAttentionModel as JaxModel
from mdd_tpu.models.ctc_model import ModelConfig as JaxConfig
from mdd_tpu_torch.convert import flax_to_torch, random_flax_variables
from mdd_tpu_torch.models.ctc_model import CTCAttentionModel, ModelConfig

SMALL = dict(input_dim=243, num_class=12, conv_channels=(4, 4),
             rnn_hidden_size=16, rnn_layers=2, text_embed_size=8,
             text_vocab_size=14)


def _perturbed(tree, rng):
    """Move every leaf off its init value (BN stats off identity) so the
    bridge's mapping of each leaf shows in the output."""
    return jax.tree.map(
        lambda v: np.asarray(v) + rng.uniform(0.0, 0.2, v.shape)
        .astype(np.float32), tree)


def _pair(use_text_attention, use_pallas_lstm, seed=0):
    kw = dict(SMALL, use_text_attention=use_text_attention,
              use_pallas_lstm=use_pallas_lstm)
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    jmodel = JaxModel(jcfg)
    variables = jmodel.init(jax.random.key(seed),
                            np.zeros((1, 16, 243), np.float32),
                            np.zeros((1, 4), np.int32),
                            np.asarray([4], np.int32))
    rng = np.random.default_rng(seed)
    params = _perturbed(variables["params"], rng)
    stats = _perturbed(variables["batch_stats"], rng)
    tmodel = CTCAttentionModel(tcfg)
    tmodel.load_state_dict(flax_to_torch(params, stats), strict=True)
    tmodel.eval()
    return jmodel, {"params": params, "batch_stats": stats}, tmodel


def _inputs(seed, b=3, t=24, l=8):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, 243)).astype(np.float32)
    trans = rng.integers(2, 12, (b, l)).astype(np.int32)
    lengths = np.asarray([l, 5, 1][:b], np.int32)     # ragged
    return feats, trans, lengths


@pytest.mark.parametrize("use_text_attention", [True, False])
@pytest.mark.parametrize("use_pallas_lstm", [True, False])
def test_log_probs_match_jax(use_text_attention, use_pallas_lstm):
    """(T', B, C) log-probs at 1e-4: float32 throughout, the difference is
    summation order in the convs, the LSTM dots and the attention."""
    jmodel, variables, tmodel = _pair(use_text_attention, use_pallas_lstm)
    feats, trans, lengths = _inputs(1)
    ref = jmodel.apply(variables, feats, trans, lengths, train=False)
    with torch.inference_mode():
        out = tmodel(torch.from_numpy(feats), torch.from_numpy(trans).long(),
                     torch.from_numpy(lengths).long())
    assert out.shape == ref.shape == (12, 3, 12)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_no_trans_lengths_means_unmasked_attention():
    jmodel, variables, tmodel = _pair(True, True, seed=2)
    feats, trans, _ = _inputs(3, b=2)
    ref = jmodel.apply(variables, feats, trans, None, train=False)
    with torch.inference_mode():
        out = tmodel(torch.from_numpy(feats), torch.from_numpy(trans).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_train_mode_is_not_ported_yet():
    """The name dates from when the port refused `use_fused_dropout`; now
    train mode is ported whole.  A config that asks for the fused dropout
    runs: train-mode output is finite, differs from eval's, is repeatable
    from the generator's seed, and gradients reach every parameter.  Both
    kinds of dropout need their generator."""
    feats, trans, lengths = _inputs(4)
    args = (torch.from_numpy(feats), torch.from_numpy(trans).long(),
            torch.from_numpy(lengths).long())
    fused = CTCAttentionModel(ModelConfig(**SMALL, use_fused_dropout=True))
    fused.init_parameters(torch.Generator().manual_seed(0))
    outs = [fused(*args, train=True,
                  generator=torch.Generator().manual_seed(seed))
            for seed in (7, 7, 8)]
    assert torch.isfinite(outs[0]).all() and outs[0].shape == (12, 3, 12)
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    outs[0].sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in fused.parameters())
    with pytest.raises(ValueError, match="generator"):
        fused(*args, train=True)
    _, _, tmodel = _pair(True, True)
    with pytest.raises(ValueError, match="generator"):
        tmodel(*args, train=True)


@pytest.mark.parametrize("use_pallas_lstm", [True, False])
def test_train_mode_matches_jax(use_pallas_lstm):
    """flax's train mode at dropout 0: log-probs from the batch statistics
    of the rows sample_mask keeps, and the updated running averages."""
    kw = dict(SMALL, dropout=0.0, use_pallas_lstm=use_pallas_lstm)
    jmodel = JaxModel(JaxConfig(**kw))
    _, variables, _ = _pair(True, use_pallas_lstm, seed=5)
    tmodel = CTCAttentionModel(ModelConfig(**kw))
    tmodel.load_state_dict(flax_to_torch(variables["params"],
                                         variables["batch_stats"]))
    feats, trans, lengths = _inputs(6)
    mask = np.array([True, False, True])
    ref, upd = jmodel.apply(variables, feats, trans, lengths, train=True,
                            sample_mask=mask, mutable=["batch_stats"])
    out = tmodel(torch.from_numpy(feats), torch.from_numpy(trans).long(),
                 torch.from_numpy(lengths).long(), train=True,
                 sample_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-4)
    want = flax_to_torch(variables["params"], upd["batch_stats"])
    for name, buf in tmodel.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_conv_biases_get_a_zero_gradient_in_train_mode():
    """A conv bias feeds a train-mode BN, which subtracts it again with the
    batch mean: its gradient is 0, and the port returns zeros (a tensor,
    so Adam still steps), where mdd_tpu's autodiff returns rounding noise.
    Moving the biases leaves train-mode log-probs as they were, up to
    rounding; in eval mode they count and get a gradient."""
    kw = dict(SMALL, dropout=0.0)
    jmodel = JaxModel(JaxConfig(**kw))
    # flax's init (the perturbed weights of `_pair` saturate the LSTMs,
    # and the log-probs would not see the convs at all)
    variables = jax.device_get(jmodel.init(
        jax.random.key(7), np.zeros((1, 16, 243), np.float32),
        np.zeros((1, 4), np.int32), np.asarray([4], np.int32)))
    tmodel = CTCAttentionModel(ModelConfig(**kw))
    tmodel.load_state_dict(flax_to_torch(variables["params"],
                                         variables["batch_stats"]))
    feats, trans, lengths = _inputs(8)
    mask = np.array([True, False, True])
    w = np.random.default_rng(9).standard_normal((12, 3, 12)).astype(
        np.float32)
    args = (torch.from_numpy(feats), torch.from_numpy(trans).long(),
            torch.from_numpy(lengths).long())
    biases = [f"conv.conv{i}.bias" for i in range(2)]

    def jax_loss(params):
        out, _ = jmodel.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              feats, trans, lengths, train=True,
                              sample_mask=mask, mutable=["batch_stats"])
        return (out * w).sum()

    g_j = flax_to_torch(jax.grad(jax_loss)(variables["params"]),
                        variables["batch_stats"])
    state = {k: v.clone() for k, v in tmodel.state_dict().items()}
    out = tmodel(*args, train=True, sample_mask=torch.from_numpy(mask))
    (out * torch.from_numpy(w)).sum().backward()
    grads = {k: p.grad for k, p in tmodel.named_parameters()}
    scale = g_j["conv.conv0.kernel"].abs().max().item()
    for name in biases:
        assert torch.equal(grads[name], torch.zeros_like(grads[name])), name
        assert g_j[name].abs().max().item() <= 1e-5 * scale, name
    np.testing.assert_allclose(grads["conv.conv0.kernel"].numpy(),
                               g_j["conv.conv0.kernel"].numpy(),
                               atol=1e-4, rtol=1e-3)

    moved = dict(state, **{k: state[k] + 0.5 for k in biases})
    tmodel.load_state_dict(moved)
    with torch.no_grad():
        again = tmodel(*args, train=True, sample_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(again.numpy(), out.detach().numpy(),
                               atol=1e-4)
    tmodel.load_state_dict(state)
    with torch.no_grad():
        before = tmodel(*args)
    tmodel.load_state_dict(moved)
    with torch.no_grad():
        after = tmodel(*args)
    assert (after - before).abs().max().item() > 1e-3
    tmodel.zero_grad()
    (tmodel(*args) * torch.from_numpy(w)).sum().backward()
    for name, p in tmodel.named_parameters():
        if name in biases:
            assert p.grad.abs().max().item() > 1e-3, name


@pytest.mark.parametrize("use_text_attention", [True, False])
def test_random_flax_variables_has_the_flax_tree(use_text_attention):
    """The seeded weights chip_smoke.py runs have exactly the leaves and
    shapes flax's init gives the same config."""
    cfg = dict(SMALL, use_text_attention=use_text_attention)
    variables = JaxModel(JaxConfig(**cfg)).init(
        jax.random.key(0), np.zeros((1, 16, 243), np.float32),
        np.zeros((1, 4), np.int32), np.asarray([4], np.int32))
    params, stats = random_flax_variables(ModelConfig(**cfg), seed=0)
    shapes = lambda t: jax.tree.map(lambda v: tuple(np.shape(v)), t)
    assert shapes(params) == shapes(jax.device_get(variables["params"]))
    assert shapes(stats) == shapes(jax.device_get(variables["batch_stats"]))


def test_config_properties_match():
    j, t = JaxConfig(), ModelConfig()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.conv_output_dim(), j.encoder_dim, j.time_downsample) == (
        t.conv_output_dim(), t.encoder_dim, t.time_downsample)
    assert [j.output_frames(n) for n in range(1, 40)] == [
        t.output_frames(n) for n in range(1, 40)]
