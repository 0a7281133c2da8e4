"""Port product inference with the lexicon vs mdd_tpu's, at a small width
on the CPU, both engines with the real `Phonetic` on one dictionary
written by tests/test_torch_lexicon.py's helper: word-only serving
requests (greedy and beam + LM; canonical phones, ipa, translation and
phonics from the word), the IPA display and forgiveness levels,
`diagnose_dir`'s reports line for line (all but the RTF timing lines) and
its decode dump, the TextGrid prompt mode, `warmup`'s shape count, and
the `infer` and `serve --max-batch 2` subcommands on `--device cpu`."""

import dataclasses
import io
import json

import numpy as np
import pytest

from mdd_tpu.data.vocab import Vocab as JaxVocab
from mdd_tpu.frontend.cmvn import parse_kaldi_cmvn_text as jax_parse_cmvn
from mdd_tpu.infer import InferenceEngine as JaxEngine
from mdd_tpu.infer import WordDiagnosis as JaxWordDiagnosis
from mdd_tpu.infer import read_phonemes_from_textgrid as jax_read_textgrid
from mdd_tpu.lexicon.dictionary import Phonetic as JaxPhonetic
from mdd_tpu.models.ctc_model import ModelConfig as JaxConfig
from mdd_tpu.serve import handle_requests as jax_handle_requests
from mdd_tpu_torch import cli
from mdd_tpu_torch.convert import flax_to_torch, random_flax_variables
from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.decode.lm_train import train_phone_lm
from mdd_tpu_torch.frontend.cmvn import (CmvnStats, parse_kaldi_cmvn_text,
                                         write_kaldi_cmvn_text)
from mdd_tpu_torch.frontend.pipeline import BatchedFbank
from mdd_tpu_torch.frontend.wav import read_audio, write_wav
from mdd_tpu_torch.infer import (InferenceEngine, WordDiagnosis,
                                 read_phonemes_from_textgrid)
from mdd_tpu_torch.lexicon.dictionary import Phonetic
from mdd_tpu_torch.lexicon.phones import CANONICAL_UNITS_43
from mdd_tpu_torch.models.ctc_model import ModelConfig
from mdd_tpu_torch.serve import handle_request, handle_requests
from mdd_tpu_torch.train.checkpoint import save_checkpoint
from test_torch_lexicon import write_dictionary
from test_torch_prepare import SHORT_TG, textgrid_long

UNITS = CANONICAL_UNITS_43
CFG = dict(input_dim=243, num_class=len(UNITS) + 2, conv_channels=(4, 4),
           rnn_hidden_size=16, rnn_layers=2, text_embed_size=8,
           text_vocab_size=len(UNITS) + 4, use_pallas_lstm=False)
# mdd_tpu on its scan LSTM, which compiles faster than its Pallas kernel in
# interpret mode; the port takes the plain version on the CPU either way
# prompt words: in every table, in some, in none (the rule fallback)
WORDS = ["about", "gather", "vocabulary", "through", "blorptastic",
         "magazine", "talked", "bananas"]
# two lengths, so that mdd_tpu's jit compiles few shapes
SECONDS = (0.6, 0.6, 1.1, 0.6, 1.1, 0.6, 1.1, 0.6)
RTF_PREFIXES = ("RTF:", "init model time:", "process time:")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Wavs with their prompt files, units, CMVN, LM, dictionary, weights
    and a checkpoint: everything both packages share."""
    root = tmp_path_factory.mktemp("infer")
    rng = np.random.default_rng(0)
    wav_dir = root / "pairs"
    wav_dir.mkdir()
    paths = []
    for i, secs in enumerate(SECONDS):
        n = int(secs * 16000)
        t = np.arange(n) / 16000.0
        sig = (3000 * np.sin(2 * np.pi * (180 + 130 * i) * t)
               + 800 * rng.standard_normal(n))
        path = wav_dir / f"{i + 1}.wav"
        write_wav(str(path), sig.astype(np.float32), 16000)
        (wav_dir / f"{i + 1}.txt").write_text(WORDS[i] + "\n")
        paths.append(str(path))
    # a prompt without a wav and a wav without a prompt: both skipped
    (wav_dir / "orphan.txt").write_text("about\n")
    write_wav(str(wav_dir / "9.wav"), np.zeros(8000, np.float32), 16000)
    (root / "units").write_text("\n".join(UNITS) + "\n")
    feats = BatchedFbank(device="cpu")([read_audio(p)[0] for p in paths])
    write_kaldi_cmvn_text(CmvnStats.accumulate(feats), str(root / "cmvn.txt"))
    (root / "phn_text").write_text("".join(
        f"u{i} {' '.join(np.roll(UNITS, 5 * i)[:30])}\n" for i in range(12)))
    train_phone_lm(str(root / "phn_text"), str(root / "lm.arpa"))
    asset_dir, ecdict = write_dictionary(root / "dict")
    # seeded weights in the flax layout, without flax's slow init
    params, stats = random_flax_variables(ModelConfig(**CFG), 0)
    variables = {"params": params, "batch_stats": stats}
    state = flax_to_torch(params, stats)
    save_checkpoint(str(root / "ckpt"), "best", state,
                    {"model_config": dataclasses.asdict(ModelConfig(**CFG))})
    return dict(root=root, wav_dir=wav_dir, paths=paths, variables=variables,
                state=state, asset_dir=asset_dir, ecdict=ecdict,
                cmvn=str(root / "cmvn.txt"), lm=str(root / "lm.arpa"))


def _engines(world, **kw):
    jax_engine = JaxEngine(
        JaxConfig(**CFG), world["variables"], JaxVocab(UNITS),
        jax_parse_cmvn(world["cmvn"]),
        phonetic=JaxPhonetic(world["asset_dir"], world["ecdict"]), **kw)
    engine = InferenceEngine(
        ModelConfig(**CFG), world["state"], Vocab(UNITS),
        parse_kaldi_cmvn_text(world["cmvn"]),
        phonetic=Phonetic(world["asset_dir"], world["ecdict"]),
        device="cpu", **kw)
    return jax_engine, engine


@pytest.fixture(scope="module")
def greedy(world):
    return _engines(world, decode_type="greedy")


@pytest.fixture(scope="module")
def beam(world):
    return _engines(world, decode_type="Beam", beam_width=4,
                    lm_path=world["lm"], lm_alpha=0.5)


_FIELDS = ("status", "id", "word", "score", "correct", "total",
           "canonical_row", "ops_row", "decoded_row", "insertion_faults",
           "substitution_faults", "deletion_faults", "ipa", "translation",
           "phonics", "batch", "error")


def _word_requests(world):
    paths = world["paths"]
    lines = [json.dumps({"id": i, "wav": p, "word": WORDS[i]})
             for i, p in enumerate(paths)]
    lines += [
        json.dumps({"id": "upper", "wav": paths[0], "word": "ABOUT"}),
        json.dumps({"id": "override", "wav": paths[1], "word": "gather",
                    "canonical": ["g", "ae", "dh", "er"]}),
        json.dumps({"id": "missing", "wav": "/nonexistent.wav",
                    "word": "about"}),
    ]
    return lines


def _canonical(resp):
    """The canonical phones of a response's row, less the 'I' slots of
    insertions."""
    return [p for p in resp["canonical_row"].split()[2:] if p != "I"]


def _same(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert {k: a.get(k) for k in _FIELDS} == {k: b.get(k) for k in _FIELDS}


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_word_only_requests_match_jax(world, decoder, request):
    """Requests without "canonical": phones, ipa, translation and phonics
    come from the lexicon, and every field equals mdd_tpu's."""
    jax_engine, engine = request.getfixturevalue(decoder)
    lines = _word_requests(world)
    ours = handle_requests(engine, lines)
    _same(ours, jax_handle_requests(jax_engine, lines))
    ok = [r for r in ours if r["status"] == "ok"]
    assert len(ok) == len(lines) - 1
    assert all(r["ipa"].startswith("英: /") and "美: /" in r["ipa"] for r in ok)
    assert ok[0]["translation"] == "adv. 大约\nprep. 关于"
    assert ok[0]["phonics"] == "a-ə b-b ou-aʊ t-t"
    assert ok[4]["translation"] == "" and ok[4]["phonics"] == ""   # OOV
    # the override replaces the lexicon's phones for the word only
    assert _canonical(ok[-1]) == ["g", "ae", "dh", "er"]
    assert _canonical(ok[1]) == ["g", "ae", "dh", "er0"]


def test_handle_request_is_one_line(world, greedy):
    jax_engine, engine = greedy
    line = _word_requests(world)[2]
    ours = handle_request(engine, line)
    _same([ours], jax_handle_requests(jax_engine, [line]))
    assert ours["batch"] == 1 and ours["word"] == "vocabulary"


@pytest.mark.parametrize("use_ipa,forgiving", [
    (False, 0), (False, 1), (False, 2), (True, None), (True, 1)])
def test_ipa_display_and_forgiveness_match_jax(world, greedy, use_ipa,
                                               forgiving):
    jax_engine, engine = greedy
    items = [(f"u{i}", read_audio(p)[0].astype(np.float32), WORDS[i], None)
             for i, p in enumerate(world["paths"])]
    try:
        for e in greedy:
            e.use_ipa, e.forgiving = use_ipa, forgiving
        ours = engine.diagnose_words(items)
        ref = jax_engine.diagnose_words(items)
    finally:
        for e in greedy:
            e.use_ipa, e.forgiving = False, None
    assert ([dataclasses.asdict(d) for d in ours]
            == [dataclasses.asdict(d) for d in ref])
    if use_ipa:
        assert any("ə" in d.canonical_row for d in ours)


def _split_logs(lines):
    text = "\n".join(lines).splitlines()
    return ([l for l in text if not l.startswith(RTF_PREFIXES)],
            [l for l in text if l.startswith(RTF_PREFIXES)])


@pytest.mark.parametrize("mode", ["lexicon", "textgrid"])
def test_diagnose_dir_matches_jax(world, greedy, mode, tmp_path):
    """One report per pair, in name order, line for line; the dump; the
    three RTF lines.  In the textgrid mode the canonical phones come from
    N.TextGrid (a pair without one is skipped)."""
    jax_engine, engine = greedy
    tg_dir = None
    if mode == "textgrid":
        tg_dir = tmp_path / "tg"
        tg_dir.mkdir()
        marks = [(0, 0.2, ""), (0.2, 0.4, "G"), (0.4, 0.6, "AE1"),
                 (0.6, 0.8, "DH"), (0.8, 1.0, "ER0")]
        for n in (1, 2, 5):
            (tg_dir / f"{n}.TextGrid").write_text(textgrid_long(
                [("words", [(0, 1.0, "x")]), ("phones", marks[: n + 1])]))
        (tg_dir / "3.TextGrid").write_text(SHORT_TG.replace(
            '"phones"', '"words"\n0\n1\n1\n0\n1\n"x"\n"IntervalTier"\n'
            '"phones"').replace("<exists>\n2", "<exists>\n3"))
    logs = {}
    for name, e in (("ours", engine), ("ref", jax_engine)):
        out = []
        e.diagnose_dir(str(world["wav_dir"]), log=out.append,
                       textgrid_dir=str(tg_dir) if tg_dir else None,
                       decode_dump=str(tmp_path / f"{name}.dump"))
        logs[name] = _split_logs(out)
    assert logs["ours"][0] == logs["ref"][0]
    assert [l.split(":")[0] for l in logs["ours"][1]] == [
        "RTF", "init model time", "process time"]
    dump = (tmp_path / "ours.dump").read_text()
    assert dump == (tmp_path / "ref.dump").read_text()
    n_pairs = 8 if mode == "lexicon" else 4
    assert len(dump.splitlines()) == n_pairs
    assert sum(l.startswith("score  :") for l in logs["ours"][0]) == n_pairs
    if mode == "textgrid":
        assert "canonical : ah" not in "\n".join(logs["ours"][0])


def test_read_phonemes_from_textgrid_matches_jax(tmp_path):
    marks = [(0, 0.1, ""), (0.1, 0.2, "AH0"), (0.2, 0.3, "ER0"),
             (0.3, 0.4, "K1"), (0.4, 0.5, "sp"), (0.5, 0.6, "AX"),
             (0.6, 0.7, "ERR"), (0.7, 1.0, "W`")]
    path = tmp_path / "w.TextGrid"
    path.write_text(textgrid_long([("words", [(0, 1.0, "x")]),
                                   ("phones", marks)]))
    ours = read_phonemes_from_textgrid(str(path))
    assert ours == jax_read_textgrid(str(path))
    assert ours == ["sil", "ah", "er", "k", "sil", "ah", "err", "w"]


@pytest.mark.parametrize("extras", [("", ""), ("a-ə b-b", "adv. 大约")])
def test_render_matches_jax(extras):
    phonics, translation = extras
    fields = dict(utt_id="3", word="about", ipa_display="英: /əˈbaʊt/ ",
                  translation=translation, canonical_row="canonical : ah0 b",
                  ops_row="            -   S", decoded_row="decode    : ah0 p",
                  insertion_faults=[], substitution_faults=["b"],
                  deletion_faults=["t", "aw"], correct=1, total=4, score=25,
                  phonics=phonics)
    text = WordDiagnosis(**fields).render()
    assert text == JaxWordDiagnosis(**fields).render()
    assert ("phonics: " in text) == bool(phonics)


def test_warmup_shape_count_matches_jax(world, greedy):
    """warmup covers batch rungs x LABEL_QUANTUM widths x length buckets,
    as mdd_tpu's does (its own test: 2 x 2 x 2 = 8)."""
    jax_engine, engine = greedy
    kw = dict(max_seconds=0.64, batch_sizes=(1,), max_canonical_phones=16)
    forwards = engine.session.forwards
    assert engine.warmup(**kw) == jax_engine.warmup(**kw) == 2
    assert engine.session.forwards == forwards + 2
    assert engine.warmup(max_seconds=1.28, batch_sizes=(1, 2)) == 8
    assert engine.BATCH_SIZES == jax_engine.BATCH_SIZES == (1, 4, 16)


def test_engine_without_dictionary_fails_at_construction(world, monkeypatch):
    monkeypatch.delenv("MDD_DICT_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="MDD_DICT_DIR"):
        InferenceEngine(ModelConfig(**CFG), world["state"], Vocab(UNITS),
                        parse_kaldi_cmvn_text(world["cmvn"]), device="cpu")


def _conf(world, decode_type="Greedy"):
    conf = world["root"] / f"{decode_type}.yaml"
    conf.write_text(f"vocab_file: {world['root'] / 'units'}\n"
                    f"decode_type: {decode_type}\nbeam_width: 4\n"
                    f"lm_path: {world['lm']}\nlm_alpha: 0.5\n")
    return str(conf)


def test_infer_subcommand_matches_jax_engine(world, greedy, tmp_path,
                                             capsys):
    """`infer --device cpu` with --phonetic-format ipa --forgiving 1 and a
    decode dump prints what mdd_tpu's engine logs with the same options
    (both without the denoiser: tests/test_torch_socket.py holds `infer`
    with it)."""
    jax_engine, _ = greedy
    dump = tmp_path / "decode_seq.txt"
    rc = cli.main(["infer", "--wav-transcript-path", str(world["wav_dir"]),
                   "--conf", _conf(world), "--checkpoint",
                   str(world["root"] / "ckpt"), "--cmvn", world["cmvn"],
                   "--dict-dir", world["asset_dir"], "--ecdict-csv",
                   world["ecdict"], "--phonetic-format", "ipa",
                   "--forgiving", "1", "--decode-dump", str(dump),
                   "--no-denoise", "--device", "cpu"])
    assert rc == 0
    ours = _split_logs([capsys.readouterr().out])
    ref_log = []
    try:
        jax_engine.use_ipa, jax_engine.forgiving = True, 1
        jax_engine.diagnose_dir(str(world["wav_dir"]), log=ref_log.append,
                                decode_dump=str(tmp_path / "ref.txt"))
    finally:
        jax_engine.use_ipa, jax_engine.forgiving = False, None
    assert ours[0] == _split_logs(ref_log)[0]
    assert len(ours[1]) == 3
    assert dump.read_text() == (tmp_path / "ref.txt").read_text()


def test_serve_subcommand_word_only_max_batch_2(world, beam, monkeypatch,
                                                capsys):
    """`serve --max-batch 2` on word-only lines: every response ok, no
    group past 2, the answers of the beam engine with the YAML's beam."""
    _, engine = beam
    lines = _word_requests(world)[:5]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    rc = cli.main(["serve", "--conf", _conf(world, "Beam"), "--cmvn",
                   world["cmvn"], "--checkpoint", str(world["root"] / "ckpt"),
                   "--dict-dir", world["asset_dir"], "--ecdict-csv",
                   world["ecdict"], "--max-batch", "2", "--no-denoise",
                   "--device", "cpu", "--quiet"])
    assert rc == 0
    resps = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [r["status"] for r in resps] == ["ok"] * 5
    assert max(r["batch"] for r in resps) <= 2
    want = [handle_requests(engine, [l])[0] for l in lines]
    for a, b in zip(resps, want):
        for k in _FIELDS:
            if k != "batch":
                assert a.get(k) == b.get(k), k
