"""The port's feature front end vs mdd_tpu's, on the CPU: MFCC against the
Kaldi goldens of tests/fixtures/mfcc_goldens.npz (atol 5e-4, the bar of
tests/test_mfcc_golden.py) and against mdd_tpu's compute_mfcc /
compute_mfcc_batch (atol 2e-4) with use_energy off and on; the DCT and
lifter tables; the spectrogram, mel_warp and make_spectrum's ark;
extract_split and featurize_wavs for fbank and MFCC (features within
2e-4, CMVN stats within rtol 1e-5); fbank dither; and the `feat` command
for the three feature types against mdd_tpu's `feat` files.

Every tolerance is absolute, on features of unit scale or on log
energies: the two packages run the same float32 products in another
summation order.  The spectrogram's log1p of a DFT magnitude adds one
more term: a bin whose sum nearly cancels (a small magnitude out of a
large frame) carries the rounding of that sum, a few float32 ulps of
sum_n |x_n w_n|, through log1p's slope 1 / (1 + magnitude) and the
normalization's 1 / std.  Its tolerance is 2e-4 plus 4 such ulps,
element by element (`_spec_tol`); where the magnitude is large the 2e-4
is all of it.  Features written by extract_split / featurize_wavs / `feat`
hold the same bar for the same reason (`_feat_tol`): a log-mel of a band
the signal barely has (after preemphasis, the lowest bins) carries the
DFT's rounding through its power, and CMVN multiplies each dimension's
rounding by 1 / std, which is ~50 for the log energy of a signal of
nearly constant loudness."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdd_tpu import cli as jax_cli
from mdd_tpu.frontend import fbank as jax_fbank
from mdd_tpu.frontend import kaldi_io as jax_kaldi_io
from mdd_tpu.frontend import mfcc as jax_mfcc
from mdd_tpu.frontend import pipeline as jax_pipeline
from mdd_tpu.frontend import spectrogram as jax_spec
from mdd_tpu.frontend.cmvn import parse_kaldi_cmvn_text as jax_parse_cmvn
from mdd_tpu_torch import cli
from mdd_tpu_torch.frontend import fbank, kaldi_io, mfcc, pipeline
from mdd_tpu_torch.frontend import spectrogram as spec
from mdd_tpu_torch.frontend.cmvn import parse_kaldi_cmvn_text
from mdd_tpu_torch.frontend.wav import read_wav, write_wav

FIXTURES = pathlib.Path(__file__).parent / "fixtures" / "mfcc_goldens.npz"
ATOL = 2e-4        # against mdd_tpu
GOLDEN_ATOL = 5e-4  # against the Kaldi transcription
CMVN_RTOL = 1e-5


@pytest.fixture(scope="module")
def goldens():
    return np.load(FIXTURES)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("name", ["synthetic", "demo1", "demo2", "demo3"])
def test_mfcc_matches_kaldi_golden(goldens, name):
    gold = goldens[f"{name}_feats"]
    ours = mfcc.compute_mfcc(_t(goldens[f"{name}_wave"])).numpy()
    assert ours.shape == gold.shape == (gold.shape[0], 13)
    np.testing.assert_allclose(ours, gold, atol=GOLDEN_ATOL)


def test_mfcc_use_energy_matches_kaldi_golden(goldens):
    wave = _t(goldens["synthetic_wave"])
    ours = mfcc.compute_mfcc(wave, mfcc.MfccConfig(use_energy=True)).numpy()
    np.testing.assert_allclose(ours, goldens["synthetic_feats_energy"],
                               atol=GOLDEN_ATOL)


def _waves(seed: int, seconds=(0.31, 0.9, 1.37)):
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(seconds):
        n = int(s * 16000)
        t = np.arange(n) / 16000.0
        out.append((3000 * np.sin(2 * np.pi * (200 + 150 * i) * t)
                    + 400 * rng.standard_normal(n)).astype(np.float32))
    return out


@pytest.mark.parametrize("use_energy", [False, True])
def test_mfcc_matches_jax(goldens, use_energy):
    cfg = mfcc.MfccConfig(use_energy=use_energy)
    jcfg = jax_mfcc.MfccConfig(use_energy=use_energy)
    for wave in [goldens["demo1_wave"]] + _waves(0):
        ours = mfcc.compute_mfcc(_t(wave), cfg).numpy()
        ref = np.asarray(jax_mfcc.compute_mfcc(jnp.asarray(wave), jcfg))
        np.testing.assert_allclose(ours, ref, atol=ATOL)
    waves = _waves(1)
    lengths = np.asarray([len(w) for w in waves], np.int32)
    batch = np.zeros((len(waves), 24000), np.float32)
    for i, w in enumerate(waves):
        batch[i, : len(w)] = w
    ours, counts = mfcc.compute_mfcc_batch(_t(batch), lengths, cfg)
    ref, ref_counts = jax_mfcc.compute_mfcc_batch(
        jnp.asarray(batch), jnp.asarray(lengths), jcfg)
    assert np.array_equal(counts, np.asarray(ref_counts))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


def test_dct_and_lifter_tables_equal_jax():
    for args in [(23, 13, 22.0), (40, 20, 0.0), (80, 13, 22.0)]:
        for a, b in zip(mfcc._dct_and_lifter(*args),
                        jax_mfcc._dct_and_lifter(*args)):
            assert a.dtype == np.float32 and np.array_equal(a, b)
    assert mfcc.MfccConfig().fbank_config() == fbank.FbankConfig(
        **{k: v for k, v in vars(
            jax_mfcc.MfccConfig().fbank_config()).items()})


def _spec_tol(wave, window: str = "hamming", normalize: bool = True):
    """The spectrogram's tolerance, element by element (module docstring):
    ATOL + 4 float32 ulps of sum_n |x_n w_n| / (1 + magnitude) / std."""
    n_fft, hop, n = 400, 160, len(wave)
    t = 1 + max(0, n - n_fft) // hop
    idx = np.clip(np.arange(t)[:, None] * hop + np.arange(n_fft), 0, n - 1)
    w = jax_fbank._window_function(jax_fbank.FbankConfig(window_type=window))
    frame_sum = np.abs(np.asarray(wave, np.float64)[idx] * w).sum(axis=1)
    raw = np.asarray(jax_spec.compute_spectrogram(
        jnp.asarray(wave), window=window, normalize=False), np.float64)
    std = max(raw.std(), 1e-8) if normalize else 1.0
    eps = float(np.finfo(np.float32).eps)
    return ATOL + 4 * eps * frame_sum[:, None] / np.exp(raw) / std


def _assert_within(ours, ref, tol):
    err = np.abs(np.asarray(ours, np.float64) - np.asarray(ref, np.float64))
    assert err.shape == np.shape(tol) or np.ndim(tol) == 0
    worst = np.unravel_index(np.argmax(err - tol), err.shape)
    assert (err <= tol).all(), (worst, err[worst], np.broadcast_to(
        tol, err.shape)[worst])


@pytest.mark.parametrize("kw", [{}, {"window": "hanning"},
                                {"normalize": False}])
def test_spectrogram_and_mel_warp_match_jax(kw):
    for wave in _waves(2) + _waves(4) + [
            np.linspace(-1, 1, 300).astype(np.float32)]:
        ours = spec.compute_spectrogram(_t(wave), **kw)
        ref = jax_spec.compute_spectrogram(jnp.asarray(wave), **kw)
        assert ours.shape == ref.shape
        tol = _spec_tol(wave, **kw)
        _assert_within(ours.numpy(), ref, tol)
        # mel_warp interpolates two bins: its error is within the same
        # interpolation of their tolerances
        _assert_within(spec.mel_warp(ours).numpy(), jax_spec.mel_warp(ref),
                       spec.mel_warp(torch.from_numpy(tol)).numpy())


@pytest.fixture(scope="module")
def wav_scp(tmp_path_factory):
    """A wav.scp of 5 seeded wavs of 0.3-1.4 s -> (scp path, {utt: path})."""
    d = tmp_path_factory.mktemp("feats")
    paths = {}
    for i, w in enumerate(_waves(3, (0.3, 0.55, 0.8, 1.1, 1.4))):
        paths[f"utt{i}"] = str(d / f"utt{i}.wav")
        write_wav(paths[f"utt{i}"], w, 16000)
    scp = d / "wav.scp"
    scp.write_text("".join(f"{u} {p}\n" for u, p in paths.items()))
    return str(scp), paths


def test_make_spectrum_matches_jax(wav_scp, tmp_path):
    scp, _ = wav_scp
    assert spec.make_spectrum(scp, str(tmp_path / "o.ark"),
                              str(tmp_path / "o.scp"), log=lambda m: None,
                              device="cpu") == 5
    jax_spec.make_spectrum(scp, str(tmp_path / "r.ark"),
                           str(tmp_path / "r.scp"), log=lambda m: None)
    _same_split(tmp_path / "o.scp", tmp_path / "r.scp", wav_scp[1])


def _feat_tol(wave, cfg, cmvn=None):
    """fbank / MFCC tolerance, element by element (module docstring): ATOL
    plus each feature's rounding before CMVN times CMVN's 1 / std.  That
    rounding is 4 float32 ulps of the value and, for a log-mel, the
    first-order error of its power: each DFT bin off by one ulp of
    sum_n |x_n w_n| in its real and imaginary parts, carried through
    |X|^2, the mel weights and log (the reference spectrum in float64).
    An MFCC mixes all 23 log-mels through the DCT, whose rounding
    averages out: it is held to the 4 ulps alone."""
    mf = isinstance(cfg, mfcc.MfccConfig)
    fb_cfg = cfg.fbank_config() if mf else cfg
    eps = float(np.finfo(np.float32).eps)
    n_t = fbank.num_frames(len(wave), fb_cfg)
    idx = (np.arange(n_t)[:, None] * fb_cfg.frame_shift
           + np.arange(fb_cfg.frame_length))
    frames = np.asarray(wave, np.float64)[idx]
    frames = frames - frames.mean(axis=1, keepdims=True)
    log_energy = np.log(np.maximum((frames ** 2).sum(axis=1), eps))
    frames = np.concatenate([frames[:, :1] * (1 - fb_cfg.preemphasis),
                             frames[:, 1:] - fb_cfg.preemphasis
                             * frames[:, :-1]], axis=1)
    frames = frames * fbank._window_function(fb_cfg)
    nbins = fb_cfg.padded_length // 2
    spec_ = np.fft.rfft(frames, fb_cfg.padded_length, axis=1)[:, :nbins]
    bank = fbank._dft_and_mel_matrices(fb_cfg)[1].astype(np.float64)
    log_mel = np.log(np.maximum(np.abs(spec_) ** 2 @ bank, eps))
    d_energy = 4 * eps * np.abs(log_energy)[:, None]
    if mf:
        dct, lifter = mfcc._dct_and_lifter(cfg.num_mel_bins, cfg.num_ceps,
                                           cfg.cepstral_lifter)
        d = 4 * eps * np.abs(log_mel @ dct * lifter)
        if cfg.use_energy:
            d[:, :1] = d_energy
    else:
        d_x = eps * np.abs(frames).sum(axis=1, keepdims=True)
        d_power = 2 * np.sqrt(2) * np.abs(spec_) * d_x + 2 * d_x ** 2
        d = d_power @ bank / np.exp(log_mel) + 4 * eps * np.abs(log_mel)
        if fb_cfg.use_energy:
            d = np.concatenate([d_energy, d], axis=1)
    scale = 1.0 if cmvn is None else 1.0 / np.sqrt(cmvn.var)
    return ATOL + d * scale


def _same_split(ours_scp, ref_scp, paths, cfg=None, cmvn=None):
    """Equal utterances, and each one's features within `_feat_tol` of its
    wav ({utt: path}) under cfg and the CMVN stats applied, or, without
    cfg, within the spectrogram's `_spec_tol`."""
    ours = kaldi_io.read_scp(str(ours_scp))
    ref = jax_kaldi_io.read_scp(str(ref_scp))
    assert list(ours) == list(ref)
    for u in ours:
        a, b = kaldi_io.load_mat(ours[u]), jax_kaldi_io.load_mat(ref[u])
        assert a.shape == b.shape
        wave = read_wav(paths[u])[0]
        _assert_within(a, b, _spec_tol(wave) if cfg is None
                       else _feat_tol(wave, cfg, cmvn))


def _same_cmvn(ours, ref):
    assert ours.count == ref.count
    np.testing.assert_allclose(ours.sum_sq, ref.sum_sq, rtol=CMVN_RTOL)
    # a sum may be near 0 where a coefficient averages out: its tolerance
    # is that of one frame's features, times the frame count
    np.testing.assert_allclose(ours.sum, ref.sum, rtol=CMVN_RTOL,
                               atol=ATOL * ours.count)


@pytest.mark.parametrize("kind", ["fbank", "mfcc"])
def test_extract_split_and_featurize_wavs_match_jax(wav_scp, tmp_path, kind):
    scp, paths = wav_scp
    cfg, jcfg = ((fbank.FbankConfig(), jax_fbank.FbankConfig())
                 if kind == "fbank" else
                 (mfcc.MfccConfig(), jax_mfcc.MfccConfig()))
    ours_scp, ours_cmvn = pipeline.extract_split(
        scp, str(tmp_path / "o"), name=kind, cfg=cfg, batch_size=2,
        device="cpu")
    ref_scp, ref_cmvn = jax_pipeline.extract_split(
        scp, str(tmp_path / "r"), name=kind, cfg=jcfg, batch_size=2)
    _same_split(ours_scp, ref_scp, paths, cfg, ref_cmvn)
    _same_cmvn(ours_cmvn, ref_cmvn)
    cmvn_file = tmp_path / "o" / f"global_{kind}_cmvn.txt"
    _same_cmvn(parse_kaldi_cmvn_text(str(cmvn_file)),
               jax_parse_cmvn(str(tmp_path / "r" / f"global_{kind}_cmvn.txt")))
    # with the stats given: applied, nothing written
    again, given = pipeline.extract_split(
        scp, str(tmp_path / "o2"), name=kind, cfg=cfg, cmvn=ref_cmvn,
        device="cpu")
    assert given is ref_cmvn
    assert not (tmp_path / "o2" / f"global_{kind}_cmvn.txt").exists()
    _same_split(again, ref_scp, paths, cfg, ref_cmvn)
    ours = pipeline.featurize_wavs(paths, ref_cmvn, cfg, device="cpu")
    ref = jax_pipeline.featurize_wavs(paths, ref_cmvn, jcfg)
    assert sorted(ours) == sorted(ref)
    for u in ref:
        _assert_within(ours[u], ref[u],
                       _feat_tol(read_wav(paths[u])[0], cfg, ref_cmvn))


def _frames_shape(n: int, cfg) -> tuple:
    return (fbank.num_frames(n, cfg), cfg.frame_length)


@pytest.mark.parametrize("kind", ["fbank", "mfcc"])
def test_dither_with_mdd_tpus_noise_matches_jax(goldens, monkeypatch, kind):
    """The same noise added: within 2e-4 of mdd_tpu's dithered features."""
    wave = goldens["demo2_wave"]
    key = jax.random.PRNGKey(7)
    if kind == "fbank":
        cfg, jcfg = fbank.FbankConfig(dither=1.0), jax_fbank.FbankConfig(
            dither=1.0)
        fb_cfg = cfg
        ours_fn, ref_fn = fbank.compute_fbank, jax_fbank.compute_fbank
    else:
        cfg, jcfg = mfcc.MfccConfig(dither=1.0), jax_mfcc.MfccConfig(
            dither=1.0)
        fb_cfg = cfg.fbank_config()
        ours_fn, ref_fn = mfcc.compute_mfcc, jax_mfcc.compute_mfcc
    noise = np.asarray(jax.random.normal(key, _frames_shape(len(wave),
                                                            fb_cfg)))
    monkeypatch.setattr(fbank, "dither_noise",
                        lambda shape, g, device: _t(noise)[None])
    ours = ours_fn(_t(wave), cfg, torch.Generator()).numpy()
    ref = np.asarray(ref_fn(jnp.asarray(wave), jcfg, key))
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    plain = np.asarray(ref_fn(jnp.asarray(wave), jcfg, None))
    assert np.abs(ours - plain).max() > 10 * ATOL


def test_dither_seeds_and_dither_zero(goldens):
    wave = _t(goldens["demo3_wave"])
    cfg = fbank.FbankConfig(dither=1.0)

    def run(seed):
        return fbank.compute_fbank(wave, cfg,
                                   torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    plain = fbank.compute_fbank(wave)
    # no generator: no noise, as mdd_tpu without a key
    assert torch.equal(fbank.compute_fbank(wave, cfg), plain)
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    assert torch.equal(fbank.compute_fbank(wave, fbank.FbankConfig(), g),
                       plain)
    assert torch.equal(g.get_state(), state)   # dither 0 draws nothing


@pytest.mark.parametrize("feat_type", ["fbank", "mfcc", "spectrogram"])
def test_feat_command_matches_jax(wav_scp, tmp_path, capsys, feat_type):
    scp, paths = wav_scp
    name = "fbank" if feat_type == "fbank" else feat_type
    args = ["feat", "--wav-scp", scp, "--feat-type", feat_type,
            "--batch-size", "4"]
    assert cli.main(args + ["--out-dir", str(tmp_path / "o"),
                            "--device", "cpu"]) == 0
    assert jax_cli.main(args + ["--out-dir", str(tmp_path / "r")]) == 0
    cfg = {"fbank": fbank.FbankConfig(), "mfcc": mfcc.MfccConfig(),
           "spectrogram": None}[feat_type]
    wrote = feat_type != "spectrogram"
    assert (tmp_path / "o" / f"global_{name}_cmvn.txt").exists() == wrote
    if wrote:
        stats = jax_parse_cmvn(str(tmp_path / "r" / f"global_{name}_cmvn.txt"))
        _same_split(tmp_path / "o" / f"{name}.scp",
                    tmp_path / "r" / f"{name}.scp", paths, cfg, stats)
        _same_cmvn(parse_kaldi_cmvn_text(
            str(tmp_path / "o" / f"global_{name}_cmvn.txt")), stats)
        # given stats (the text file: 6 digits) applied by both, the files
        # named by --name
        given = ["--name", "given", "--cmvn",
                 str(tmp_path / "r" / f"global_{name}_cmvn.txt")]
        assert cli.main(args + given + ["--out-dir", str(tmp_path / "o2"),
                                        "--device", "cpu"]) == 0
        assert jax_cli.main(args + given
                            + ["--out-dir", str(tmp_path / "r2")]) == 0
        _same_split(tmp_path / "o2" / "given.scp",
                    tmp_path / "r2" / "given.scp", paths, cfg, stats)
    else:
        _same_split(tmp_path / "o" / f"{name}.scp",
                    tmp_path / "r" / f"{name}.scp", paths)
        with pytest.raises(SystemExit, match="no CMVN stage"):
            cli.main(args + ["--out-dir", str(tmp_path / "o3"),
                             "--cmvn", "x", "--device", "cpu"])
    assert f"features -> {tmp_path / 'o' / name}.scp" in capsys.readouterr().out
