"""The port's visualizer (mdd_tpu_torch/utils/visualize.py) against
mdd_tpu's on the test model of tests/test_viz_spectrogram.py, with the
same seeded weights (convert.random_flax_variables, bridged by
flax_to_torch): the captured activations' names in mdd_tpu's order, their
arrays and the log-probs within tests/test_torch_model.py's 1e-4, the same
PNG files, and the ImportError that names matplotlib where it is missing."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from mdd_tpu.models.ctc_model import CTCAttentionModel as JaxModel
from mdd_tpu.models.ctc_model import ModelConfig as JaxConfig
from mdd_tpu.utils import visualize as jax_viz
from mdd_tpu_torch.convert import flax_to_torch, random_flax_variables
from mdd_tpu_torch.models.ctc_model import CTCAttentionModel, ModelConfig
from mdd_tpu_torch.utils import visualize

TOL = 1e-4     # tests/test_torch_model.py's log-prob tolerance, float32
ID2WORD = {i: f"p{i}" for i in range(8)}
# what mdd_tpu lists (its capture, then _flatten_intermediates' limit 6)
NAMES = {
    2: ["conv/__call__", "rnn0/drop/__call__", "rnn0/__call__",
        "rnn1/bn/__call__", "rnn1/drop/__call__", "rnn1/__call__"],
    1: ["conv/__call__", "rnn0/drop/__call__", "rnn0/__call__",
        "text/embed/__call__", "text/lstm/drop/__call__",
        "text/lstm/__call__"]}


def _pair(rnn_layers, use_pallas_lstm=False):
    kw = dict(input_dim=24, num_class=8, rnn_hidden_size=16,
              rnn_layers=rnn_layers, text_embed_size=16)
    params, stats = random_flax_variables(ModelConfig(**kw), seed=rnn_layers)
    model = CTCAttentionModel(ModelConfig(**kw,
                                          use_pallas_lstm=use_pallas_lstm))
    model.load_state_dict(flax_to_torch(params, stats), strict=True)
    return (JaxModel(JaxConfig(**kw)),
            {"params": params, "batch_stats": stats}, model)


def _utterance():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((32, 24)).astype(np.float32),
            np.asarray([2, 3, 4], np.int32))


def _jax_capture(jmodel, variables, feats, trans, limit=6):
    log_probs, inter = jmodel.apply(
        variables, feats[None], trans[None], np.asarray([len(trans)]),
        train=False, capture_intermediates=True, mutable=["intermediates"])
    flat = jax_viz._flatten_intermediates(inter["intermediates"],
                                          limit=limit)
    return np.asarray(log_probs), {k: np.asarray(v) for k, v in flat.items()}


@pytest.mark.parametrize("use_pallas_lstm", [False, True])
@pytest.mark.parametrize("rnn_layers", [1, 2])
def test_capture_matches_mdd_tpu(rnn_layers, use_pallas_lstm):
    """Names in order, arrays and log-probs; eval mode, no grad, the
    model's mode kept and every hook removed."""
    jmodel, variables, model = _pair(rnn_layers, use_pallas_lstm)
    feats, trans = _utterance()
    want_lp, want = _jax_capture(jmodel, variables, feats, trans)
    model.train()
    got_lp, got = visualize.capture_activations(model, feats, trans)
    assert list(want) == NAMES[rnn_layers]
    assert list(got) == list(want)
    assert got_lp.shape == want_lp.shape == (16, 1, 8)
    np.testing.assert_allclose(got_lp, want_lp, atol=TOL)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], atol=TOL,
                                   err_msg=name)
    assert model.training
    assert not any(m._forward_hooks or m._forward_pre_hooks
                   for m in model.modules())
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("rnn_layers", [1, 2])
def test_every_entry_without_the_limit_matches(rnn_layers):
    """Past the limit too: the text encoder's tuple output, the head and
    the (T', 1, C) log-probs, in mdd_tpu's order."""
    jmodel, variables, model = _pair(rnn_layers)
    feats, trans = _utterance()
    _, want = _jax_capture(jmodel, variables, feats, trans, limit=100)
    _, got = visualize.capture_activations(model, feats, trans, limit=100)
    assert list(got) == list(want)
    assert list(want)[-6:] == ["text/lstm/__call__", "text/key_proj/__call__",
                               "text/__call__", "head_bn/__call__",
                               "head/__call__", "__call__"]
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=TOL,
                                   err_msg=name)


def test_hooks_are_removed_when_the_forward_raises():
    _, _, model = _pair(2)
    feats, trans = _utterance()
    with pytest.raises(RuntimeError):
        visualize.capture_activations(model, feats[:, :20], trans)
    assert not any(m._forward_hooks or m._forward_pre_hooks
                   for m in model.modules())


@pytest.mark.parametrize("rnn_layers", [1, 2])
def test_visualize_utterance_writes_mdd_tpus_files(tmp_path, rnn_layers):
    pytest.importorskip("matplotlib")
    jmodel, variables, model = _pair(rnn_layers)
    feats, trans = _utterance()
    want = jax_viz.visualize_utterance(jmodel, variables, feats, trans,
                                       ID2WORD, str(tmp_path / "jax"))
    got = visualize.visualize_utterance(model, feats, trans, ID2WORD,
                                        str(tmp_path / "torch"))
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    assert len(got) == 8            # input, 6 activations, posteriors
    for p in got:
        assert os.path.getsize(p) > 1000, p


def test_without_matplotlib_plotting_raises_and_capture_runs(
        tmp_path, monkeypatch):
    """No silent skip: every plotting entry point raises an ImportError
    that names matplotlib; the capture needs none."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    _, _, model = _pair(2)
    feats, trans = _utterance()
    calls = [
        lambda: visualize.visualize_utterance(model, feats, trans, ID2WORD,
                                              str(tmp_path)),
        lambda: visualize.plot_heatmap(feats, "x", str(tmp_path / "x.png")),
        lambda: visualize.plot_posteriors(np.zeros((4, 8)), ID2WORD,
                                          str(tmp_path / "p.png"))]
    for call in calls:
        with pytest.raises(ImportError, match="matplotlib"):
            call()
    assert not list(tmp_path.glob("*.png"))
    _, flat = visualize.capture_activations(model, feats, trans)
    assert list(flat) == NAMES[2]


def test_capture_in_bfloat16_returns_float32():
    """A bfloat16 model's activations come back as float32 host arrays
    (numpy has no bfloat16)."""
    _, _, model = _pair(2)
    bf16 = CTCAttentionModel(dataclasses.replace(model.cfg,
                                                 compute_dtype="bfloat16"))
    bf16.load_state_dict(model.state_dict())
    feats, trans = _utterance()
    lp, flat = visualize.capture_activations(bf16, feats, trans)
    _, ref = visualize.capture_activations(model, feats, trans)
    assert lp.dtype == np.float32
    assert all(a.dtype == np.float32 for a in flat.values())
    assert list(flat) == list(ref)
    assert np.isfinite(lp).all()
