"""Port front end vs mdd_tpu's and vs the Kaldi goldens: fbank (single and
batched), CMVN, splice / skip / pad, wav I/O."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdd_tpu.frontend import cmvn as jax_cmvn
from mdd_tpu.frontend import splice as jax_splice
from mdd_tpu.frontend import wav as jax_wav
from mdd_tpu.frontend.fbank import FbankConfig as JaxFbankConfig
from mdd_tpu.frontend.fbank import compute_fbank_batch as jax_fbank_batch
from mdd_tpu.frontend.pipeline import _BatchedFbank
from mdd_tpu_torch.frontend import cmvn, splice, wav
from mdd_tpu_torch.frontend.fbank import FbankConfig, compute_fbank_batch
from mdd_tpu_torch.frontend.pipeline import BatchedFbank

GOLDENS = pathlib.Path(__file__).parent / "fixtures" / "fbank_goldens.npz"


def _fbank(waves):
    lengths = np.asarray([len(w) for w in waves], np.int32)
    batch = np.zeros((len(waves), lengths.max()), np.float32)
    for i, w in enumerate(waves):
        batch[i, : len(w)] = w
    feats, counts = compute_fbank_batch(torch.from_numpy(batch), lengths)
    return feats.numpy(), counts, batch, lengths


@pytest.mark.parametrize("name", ["synthetic", "demo1", "demo2", "demo3"])
def test_fbank_matches_kaldi_golden(name):
    """Same tolerance as mdd_tpu's own golden test (5e-4)."""
    goldens = np.load(GOLDENS)
    gold = goldens[f"{name}_feats"]
    feats, counts, _, _ = _fbank([goldens[f"{name}_wave"]])
    assert counts[0] == gold.shape[0]
    np.testing.assert_allclose(feats[0, : counts[0]], gold, atol=5e-4)


def test_fbank_batch_matches_jax():
    """Ragged batch, framed over the padded width like mdd_tpu's vmap:
    every frame (valid or padding) within 2e-4 of JAX's float32 result,
    and the same frame counts."""
    rng = np.random.default_rng(0)
    waves = [(rng.standard_normal(n) * 3000).astype(np.float32)
             for n in (4000, 9840, 399, 16000)]
    feats, counts, batch, lengths = _fbank(waves)
    ref, ref_counts = jax_fbank_batch(jnp.asarray(batch),
                                      jnp.asarray(lengths), JaxFbankConfig())
    np.testing.assert_array_equal(counts, np.asarray(ref_counts))
    np.testing.assert_allclose(feats, np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("variant", [
    dict(window_type="hanning"), dict(window_type="povey"),
    dict(window_type="rectangular"), dict(use_energy=False),
    dict(raw_energy=False), dict(use_power=False),
    dict(use_log_fbank=False), dict(snip_edges=False),
    dict(preemphasis=0.0, remove_dc_offset=False),
    dict(num_mel_bins=40, low_freq=60.0, high_freq=-400.0)])
def test_fbank_config_variants_match_jax(variant):
    """Every FbankConfig switch, one at a time; rtol for the linear-scale
    (no log) energies."""
    rng = np.random.default_rng(5)
    waves = [(rng.standard_normal(n) * 3000).astype(np.float32)
             for n in (4000, 5230)]
    lengths = np.asarray([len(w) for w in waves], np.int32)
    batch = np.zeros((2, 5230), np.float32)
    for i, w in enumerate(waves):
        batch[i, : len(w)] = w
    feats, counts = compute_fbank_batch(torch.from_numpy(batch), lengths,
                                        FbankConfig(**variant))
    ref, ref_counts = jax_fbank_batch(jnp.asarray(batch), jnp.asarray(lengths),
                                      JaxFbankConfig(**variant))
    np.testing.assert_array_equal(counts, np.asarray(ref_counts))
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=2e-4)


def test_batched_fbank_matches_jax_pipeline():
    rng = np.random.default_rng(1)
    waves = [(rng.standard_normal(n) * 2000).astype(np.float32)
             for n in (8000, 12345, 30000)]
    ours = BatchedFbank(device="cpu")(waves)
    ref = _BatchedFbank(JaxFbankConfig())(waves)
    assert [f.shape for f in ours] == [f.shape for f in ref]
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=2e-4)


def test_fbank_config_matches_jax_apart_from_dither():
    """Field for field, in order; since the port has dither too, that
    field is among them (0.0 in both, the noise drawn only with a
    generator: tests/test_torch_features.py)."""
    import dataclasses

    ref = dataclasses.asdict(JaxFbankConfig())
    assert ref["dither"] == 0.0
    assert list(dataclasses.asdict(FbankConfig()).items()) == list(ref.items())


def test_cmvn_text_round_trip_and_apply(tmp_path):
    rng = np.random.default_rng(2)
    feats = [rng.standard_normal((n, 81)).astype(np.float32) * 4 + 2
             for n in (30, 45)]
    stats = cmvn.CmvnStats.accumulate(feats)
    ref_stats = jax_cmvn.CmvnStats.accumulate(feats)
    np.testing.assert_array_equal(stats.mean, ref_stats.mean)
    np.testing.assert_array_equal(stats.var, ref_stats.var)
    path = tmp_path / "cmvn.txt"
    cmvn.write_kaldi_cmvn_text(stats, str(path))
    ref_path = tmp_path / "ref.txt"
    jax_cmvn.write_kaldi_cmvn_text(ref_stats, str(ref_path))
    assert path.read_text() == ref_path.read_text()
    parsed = cmvn.parse_kaldi_cmvn_text(str(path))
    ref_parsed = jax_cmvn.parse_kaldi_cmvn_text(str(path))
    assert parsed.count == ref_parsed.count
    np.testing.assert_array_equal(
        cmvn.apply_cmvn(feats[0], parsed),
        np.asarray(jax_cmvn.apply_cmvn(feats[0], ref_parsed)))


@pytest.mark.parametrize("left,right,skip,multiple",
                         [(0, 2, 2, 2), (1, 1, 3, 4), (0, 0, 1, 2)])
def test_splice_skip_pad_match_jax(left, right, skip, multiple):
    x = np.random.default_rng(3).standard_normal((17, 5)).astype(np.float32)
    ours = splice.pad_to_multiple(splice.skip_frames(
        splice.make_context(x, left, right), skip), multiple)
    ref = jax_splice.pad_to_multiple(jax_splice.skip_frames(
        jax_splice.make_context(x, left, right), skip), multiple)
    np.testing.assert_array_equal(ours, ref)


def test_wav_write_read_resample_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    data = (rng.standard_normal(8000) * 5000).astype(np.float32)
    path = str(tmp_path / "a.wav")
    wav.write_wav(path, data, 8000)
    ours, sr = wav.read_audio(path)
    ref, ref_sr = jax_wav.read_audio(path)
    assert sr == ref_sr == 8000
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(wav.resample(ours, 8000, 16000),
                                  jax_wav.resample(ref, 8000, 16000))
