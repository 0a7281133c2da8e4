"""The port's benchmark (mdd_tpu_torch/bench.py, `python -m mdd_tpu_torch
benchmark`) against the repo-root bench.py, on the CPU at small sizes: the
FLOP count equal to bench.py's, each section's keys, the CLI's one JSON
line with bench.py's metric, unit and every `extra` key, the device beam
on bench.py's input recipe against mdd_tpu's, the unit rule, the MFU
arithmetic and the refusals.  A few seconds a test; the full sizes run on
the card (chip_smoke.py phase benchmark)."""

import contextlib
import functools
import io
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from chip_smoke import bench_py_line_fields
from mdd_tpu.align.levenshtein import edit_distance
from mdd_tpu.data.vocab import Vocab as JaxVocab
from mdd_tpu.decode.beam_jit import BatchedBeamDecoder as JaxBatchedBeam
from mdd_tpu.models.ctc_model import ModelConfig as JaxModelConfig
from mdd_tpu_torch import bench, cli
from mdd_tpu_torch.decode.lm_train import train_phone_lm
from mdd_tpu_torch.lexicon.phones import CANONICAL_UNITS_41
from mdd_tpu_torch.models.ctc_model import ModelConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
H100 = "NVIDIA H100 80GB HBM3"
SMALL = dict(rnn_hidden_size=32, rnn_layers=2, conv_channels=(4, 4),
             text_embed_size=16, compute_dtype="bfloat16")
# each section at a size the CPU runs in seconds
SMALL_SIZES = {
    "bench_train": dict(batch=4, frames=32, label_len=6, warmup=1, steps=2),
    "bench_decode": dict(batch=4, frames=20, rounds=1),
    "bench_frontend": dict(batch=2, seconds=0.5, rounds=1, n_utts=3,
                           utt_seconds=0.5),
    "bench_eval": dict(n_utts=10, batch=4, cached_batch=8, passes=1,
                       workers=2),
    "bench_epoch": dict(n_utts=12, batch=8, epochs=1, workers=2),
}
SECTION_KEYS = {
    "bench_train": {"ms_per_step", "tflop_per_step", "peak_flops", "mfu",
                    "train_batch"},
    "bench_decode": {"decode_utts_per_s", "decode_utts_per_s_min",
                     "decode_utts_per_s_max", "decode_beam_width",
                     "decode_min_per_900_utts", "decode_vs_reference",
                     "decode_lm"},
    "bench_frontend": {"frontend_fbank_audio_s_per_s",
                       "frontend_mfcc_audio_s_per_s",
                       "feat_split_audio_s_per_s",
                       "feat_split_s_per_900_utts"},
    "bench_eval": {"eval_checkpoint", "eval_lm", "eval_n_utts",
                   "eval_utts_per_s", "eval_utts_per_s_min",
                   "eval_utts_per_s_max", "eval_min_per_900_utts",
                   "eval_vs_reference_decode", "eval_utts_per_s_cached",
                   "eval_utts_per_s_cached_max"},
    "bench_epoch": {"epoch_corpus_s", "epoch_model_num_class",
                    "epoch_audio_s", "epoch_audio_s_per_s_cached",
                    "epoch_s_cached", "cache_mb", "cache_mb_per_device",
                    "epoch_audio_s_per_s_with_pipeline", "epoch_s"},
}


@pytest.fixture(autouse=True)
def _no_reference_data(monkeypatch):
    monkeypatch.delenv(bench.REFERENCE_DATA_ENV, raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)


def test_bench_py_keys_are_read():
    keys = bench_py_line_fields()[2]
    assert len(keys) == 31
    assert {"mfu", "frontend_mfcc_audio_s_per_s", "model_num_class",
            "eval_utts_per_s_cached_max"} <= keys
    assert keys <= set().union(*SECTION_KEYS.values()) | {"model_num_class"}


@pytest.mark.parametrize("overrides,shape", [
    ({}, (512, 160, 48)),
    ({"use_text_attention": False}, (512, 160, 48)),
    ({"rnn_layers": 2}, (64, 110, 40)),
    ({"conv_strides": ((2, 2), (2, 2)), "conv_kernels": ((5, 3), (3, 3)),
      "conv_padding": ((2, 1), (0, 0))}, (16, 97, 23)),
    ({"num_class": 25, "rnn_hidden_size": 256, "conv_channels": (16, 48)},
     (1, 33, 7)),
], ids=["flagship", "no_text_attention", "2_layers", "other_strides",
        "other_widths"])
def test_train_step_flops_equals_bench_py(overrides, shape):
    want = jax_bench.train_step_flops(JaxModelConfig(**overrides), *shape)
    assert bench.train_step_flops(ModelConfig(**overrides), *shape) == want


def test_mfu_arithmetic():
    assert bench.peak_flops(H100, "bfloat16") == 989e12
    assert bench.peak_flops(H100, "float32") == 67e12
    assert bench.peak_flops("NVIDIA H100 PCIe", "bfloat16") is None
    assert bench.peak_flops("cpu", "bfloat16") is None
    assert bench.peak_flops(H100, "float16") is None
    flops = bench.train_step_flops(ModelConfig(), 512, 160, 48)
    assert round(flops / 1e12, 3) == 5.055
    mfu = bench.model_flops_utilization(flops, 0.2145, 989e12)
    assert mfu == pytest.approx(flops / 0.2145 / 989e12, rel=1e-12)
    assert 0.023 < mfu < 0.024
    assert bench.model_flops_utilization(flops, 0.2145, None) is None


@pytest.mark.parametrize("section", sorted(SMALL_SIZES))
def test_section_writes_its_keys(section):
    cfg = ModelConfig(**SMALL)
    extra = {}
    args = ((extra, "cpu") if section in ("bench_frontend", "bench_decode")
            else (cfg, extra, "cpu"))
    got = getattr(bench, section)(*args, **SMALL_SIZES[section])
    assert set(extra) == SECTION_KEYS[section]
    if section == "bench_train":
        assert got > 0 and extra["mfu"] is None and extra["peak_flops"] is None
        assert extra["train_batch"] == 4
    if section == "bench_eval":
        # bench.py's rule: the committed trained model where it is present
        trained = (ROOT / "checkpoints" / "syn_full" / "best").exists()
        assert extra["eval_checkpoint"] == ("syn_full/best" if trained
                                            else "random_init")
        assert extra["eval_n_utts"] == 10 and extra["eval_lm"] is None
    if section == "bench_epoch":
        assert extra["epoch_model_num_class"] == 43
        assert extra["cache_mb"] == extra["cache_mb_per_device"] > 0
    for k, v in extra.items():
        if isinstance(v, float):
            assert np.isfinite(v) and v >= 0, (k, v)


def test_eval_without_the_trained_checkpoint_runs_random_weights(tmp_path):
    """bench.py's fallback: no `best` in the checkpoint directory (here an
    empty one) -> seeded random weights at the section's own config."""
    extra = {}
    bench.bench_eval(ModelConfig(**SMALL), extra, "cpu",
                     checkpoint_dir=str(tmp_path), **SMALL_SIZES["bench_eval"])
    assert extra["eval_checkpoint"] == "random_init"
    assert extra["eval_utts_per_s"] > 0


def test_eval_takes_the_trained_checkpoint_only_for_its_units():
    """The trained `best` for a vocabulary of its 43 classes, random
    weights for any other; the kernels on a card only."""
    from mdd_tpu_torch.data.vocab import Vocab

    cfg = ModelConfig(**SMALL)
    state, model_cfg, tag = bench.trained_eval_state(
        cfg, Vocab(CANONICAL_UNITS_41), "cpu")
    assert tag == "syn_full/best" and model_cfg.rnn_hidden_size == 384
    assert model_cfg.compute_dtype == "float32"
    assert not model_cfg.use_pallas_lstm and len(state) == 53
    _, model_cfg, tag = bench.trained_eval_state(
        cfg, Vocab(CANONICAL_UNITS_41[:-1]), "cuda")
    assert tag == "random_init" and model_cfg is cfg


def test_train_section_mfu_against_the_listed_peak(monkeypatch):
    """On a card of PEAK_FLOPS the section divides the step's FLOPs by
    the step time and the card's peak for the compute dtype (here a card
    listed at the peak that would run the small step in 1 s, so the
    4-decimal rounding of `mfu` stays far below the value on any CPU)."""
    cfg = ModelConfig(**SMALL)
    flops = bench.train_step_flops(cfg, 4, 32, 6)
    monkeypatch.setitem(bench.PEAK_FLOPS, "test card", {"bfloat16": flops})
    monkeypatch.setattr(bench, "card_name", lambda device: "test card")
    extra = {}
    bench.bench_train(cfg, extra, "cpu", **SMALL_SIZES["bench_train"])
    assert extra["peak_flops"] == flops
    assert extra["tflop_per_step"] == round(flops / 1e12, 3)
    # ms_per_step is rounded to 0.01 ms, mfu to 1e-4
    assert extra["mfu"] == pytest.approx(
        1.0 / (extra["ms_per_step"] / 1e3), rel=1e-3, abs=5e-5)


def test_decode_matches_mdd_tpu_beam_on_bench_py_recipe():
    """bench_decode's sequences against mdd_tpu's BatchedBeamDecoder on
    bench.py's input (seed 0, blank logit + 2, K=10, no LM) at B=16,
    T'=80: the bar of tests/test_torch_beam.py (>= 15 of 16 identical,
    token error < 0.002)."""
    cfg = ModelConfig(**SMALL)
    b, t = 16, 80
    ours = bench.bench_decode({}, "cpu", batch=b, frames=t, rounds=1)
    vocab = JaxVocab([f"p{i}" for i in range(cfg.num_class - 2)])
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((b, t, vocab.n_words)).astype(np.float32)
    logits[:, :, 0] += 2.0
    log_probs = jnp.asarray(
        logits - jax.scipy.special.logsumexp(logits, -1, keepdims=True))
    want = JaxBatchedBeam(vocab.index2word, beam_width=10, lm=None,
                          lm_alpha=0.5).decode_log(log_probs, [t] * b)
    exact = sum(x == y for x, y in zip(ours, want))
    errs = sum(edit_distance(x, y)[0] for x, y in zip(ours, want))
    assert exact >= b - 1
    assert errs / sum(len(y) for y in want) < 0.002


def test_units_without_the_reference_data():
    assert bench.reference_data() is None
    assert bench.flagship_phones() == CANONICAL_UNITS_41
    assert bench.reference_lm() is None
    cfg = bench.flagship_config("cpu")
    assert cfg.num_class == 43 and cfg.compute_dtype == "bfloat16"
    assert not cfg.use_pallas_lstm
    assert bench.flagship_config("cuda").use_pallas_lstm


def _reference_data(tmp_path, units):
    (tmp_path / "units").write_text("\n".join(units) + "\n")
    phn = tmp_path / "phn_text"
    rng = np.random.default_rng(0)
    phn.write_text("".join(
        f"u{i} " + " ".join(rng.choice(units, 6)) + "\n" for i in range(20)))
    train_phone_lm(str(phn), str(tmp_path / "lm_phone_bg.arpa"))
    return tmp_path


def test_units_and_lm_from_the_reference_data(tmp_path, monkeypatch):
    units = ["sil", "aa", "bb", "cc", "err"]
    data = _reference_data(tmp_path, units)
    monkeypatch.setenv(bench.REFERENCE_DATA_ENV, str(data))
    assert bench.flagship_phones() == units
    assert bench.flagship_config("cpu").num_class == len(units) + 2
    lm = str(data / "lm_phone_bg.arpa")
    assert bench.reference_lm() == lm
    extra = {}
    seqs = bench.bench_decode(extra, "cpu", batch=3, frames=12, rounds=1)
    assert extra["decode_lm"] == lm and len(seqs) == 3
    assert all(0 < i < len(units) + 2 for s in seqs for i in s)


def test_units_without_sil_fall_back(tmp_path, monkeypatch):
    (tmp_path / "units").write_text("aa\nbb\n")
    monkeypatch.setenv(bench.REFERENCE_DATA_ENV, str(tmp_path))
    assert bench.flagship_phones() == CANONICAL_UNITS_41
    monkeypatch.setenv(bench.REFERENCE_DATA_ENV, str(tmp_path / "absent"))
    assert bench.reference_data() is None


def _small(mp):
    mp.setattr(bench, "flagship_config",
               lambda device: ModelConfig(**SMALL))
    for name, sizes in SMALL_SIZES.items():
        mp.setattr(bench, name,
                   functools.partial(getattr(bench, name), **sizes))


@pytest.fixture(scope="module")
def cli_stdout():
    """stdout of `benchmark --device cpu` with every section small."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(bench.REFERENCE_DATA_ENV, raising=False)
        mp.delenv("WORLD_SIZE", raising=False)
        _small(mp)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert cli.main(["benchmark", "--device", "cpu"]) == 0
    return out.getvalue()


def test_cli_prints_one_json_line_with_bench_py_metric_and_unit(cli_stdout):
    lines = cli_stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    metric, unit, _ = bench_py_line_fields()
    assert line["metric"] == metric
    assert line["unit"] == unit
    assert line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 317.0, 3)


def test_cli_line_holds_every_extra_key_of_bench_py(cli_stdout):
    extra = json.loads(cli_stdout)["extra"]
    assert bench_py_line_fields()[2] <= set(extra)
    assert set(extra) == (set().union(*SECTION_KEYS.values())
                          | {"model_num_class", "card", "n_cards"})
    assert extra["card"] == "cpu" and extra["model_num_class"] == 43
    assert extra["n_cards"] == 1
    assert extra["mfu"] is None and extra["decode_lm"] is None


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    assert cli.build_parser().parse_args(["benchmark"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "bench_train", pytest.fail)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["benchmark"])


def test_several_ranks_are_refused(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(bench, "bench_train", pytest.fail)
    with pytest.raises(SystemExit, match="WORLD_SIZE=2"):
        cli.main(["benchmark", "--device", "cpu"])
