"""Port serving path vs mdd_tpu's: EvalSession.decode_batch on one Batch,
handle_requests on the same JSON lines with greedy and with beam + LM
decoding (requests that carry their canonical phones, both engines on a
stub lexicon that returns empty strings; a word-only request on both
packages' real lexicon), the stdin server and the `serve` subcommand, on
the CPU at a small width.  tests/test_torch_infer.py holds the lexicon's
serving path at length."""

import dataclasses
import io
import json

import jax
import numpy as np
import pytest

from mdd_tpu.data.dataset import Batch as JaxBatch
from mdd_tpu.data.vocab import Vocab as JaxVocab
from mdd_tpu.evals.evaluate import EvalSession as JaxEvalSession
from mdd_tpu.frontend.cmvn import parse_kaldi_cmvn_text as jax_parse_cmvn
from mdd_tpu.infer import InferenceEngine as JaxEngine
from mdd_tpu.models.ctc_model import CTCAttentionModel as JaxModel
from mdd_tpu.models.ctc_model import ModelConfig as JaxConfig
from mdd_tpu.serve import handle_requests as jax_handle_requests
from mdd_tpu.utils.config import load_config as jax_load_config
from mdd_tpu_torch import cli
from mdd_tpu_torch.convert import flax_to_torch
from mdd_tpu_torch.data.dataset import Batch
from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.evals.evaluate import EvalSession
from mdd_tpu_torch.frontend.cmvn import CmvnStats, parse_kaldi_cmvn_text
from mdd_tpu_torch.frontend.cmvn import write_kaldi_cmvn_text
from mdd_tpu_torch.frontend.pipeline import BatchedFbank
from mdd_tpu_torch.frontend.wav import write_wav
from mdd_tpu_torch.infer import InferenceEngine
from mdd_tpu_torch.models.ctc_model import ModelConfig
from mdd_tpu_torch.serve import handle_requests, serve_loop
from mdd_tpu_torch.train.checkpoint import save_checkpoint
from mdd_tpu_torch.utils.config import load_config
from test_torch_lexicon import write_dictionary

UNITS = ["sil", "err", "aa", "ae", "b", "d", "k", "t", "s", "m"]
CFG = dict(input_dim=243, num_class=len(UNITS) + 2, conv_channels=(4, 4),
           rnn_hidden_size=16, rnn_layers=2, text_embed_size=8,
           text_vocab_size=14, use_pallas_lstm=True)


class StubPhonetic:
    """Lexicon stand-in for the tests that need none: every request
    carries its canonical phones, and the display fields are empty."""

    def validate_assets(self):
        pass

    def canonical_model_phones(self, word):
        raise AssertionError("requests carry 'canonical'")

    def api_word_phonetic(self, word):
        return ""

    def api_word_translation(self, word):
        return ""

    def api_word_phonics(self, word):
        return None


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Wavs, units, CMVN, weights: everything both engines share."""
    root = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(0)
    paths = []
    for i, secs in enumerate((0.6, 0.7, 1.3, 2.1, 3.2)):
        n = int(secs * 16000)
        t = np.arange(n) / 16000.0
        sig = (3000 * np.sin(2 * np.pi * (200 + 150 * i) * t)
               + 800 * rng.standard_normal(n))
        path = str(root / f"w{i}.wav")
        write_wav(path, sig.astype(np.float32), 16000)
        paths.append(path)
    (root / "units").write_text("\n".join(UNITS) + "\n")
    from mdd_tpu_torch.frontend.wav import read_audio

    feats = BatchedFbank(device="cpu")([read_audio(p)[0] for p in paths])
    write_kaldi_cmvn_text(CmvnStats.accumulate(feats), str(root / "cmvn.txt"))
    variables = JaxModel(JaxConfig(**CFG)).init(
        jax.random.key(0), np.zeros((1, 16, 243), np.float32),
        np.zeros((1, 4), np.int32), np.asarray([4], np.int32))
    variables = jax.device_get(variables)
    asset_dir, ecdict = write_dictionary(root / "dict")
    return dict(root=root, paths=paths, variables=variables,
                state=flax_to_torch(variables["params"],
                                    variables["batch_stats"]),
                asset_dir=asset_dir, ecdict=ecdict)


def _requests(paths):
    canon = [["sil", "b", "aa", "t", "sil"], ["k", "ae", "t"],
             ["s", "aa", "m", "d"], ["m", "aa"], ["b", "ae", "d", "s", "t"]]
    lines = [json.dumps({"id": i, "wav": p, "word": f"w{i}",
                         "canonical": canon[i % len(canon)]})
             for i, p in enumerate(paths + paths[:3])]
    lines.insert(2, "{not json")
    lines.insert(4, json.dumps({"id": "x", "wav": "/nonexistent.wav",
                                "word": "a", "canonical": ["aa"]}))
    return lines


def test_decode_batch_matches_jax(world):
    rng = np.random.default_rng(1)
    b, t, l = 3, 40, 8
    inputs = rng.standard_normal((b, t, 243)).astype(np.float32)
    fracs = np.asarray([1.0, 0.7, 0.33], np.float32)
    trans = rng.integers(2, 12, (b, l)).astype(np.int32)
    sizes = np.asarray([8, 3, 5], np.int32)
    fields = dict(inputs=inputs, input_fracs=fracs, targets=trans.copy(),
                  target_sizes=sizes.copy(), trans=trans, trans_sizes=sizes,
                  utt_ids=["a", "b", "c"])
    vocab = Vocab(UNITS)
    ref_lists, ref_frames = JaxEvalSession(
        JaxConfig(**CFG), world["variables"], JaxVocab(UNITS),
        decode_type="greedy").decode_batch(JaxBatch(**fields))
    session = EvalSession(ModelConfig(**CFG), world["state"], vocab,
                          device="cpu")
    lists, frames = session.decode_batch(Batch(**fields))
    np.testing.assert_array_equal(frames, ref_frames)
    assert lists == ref_lists
    assert session.forwards == 1


def _engines(world):
    cmvn_path = str(world["root"] / "cmvn.txt")
    jax_engine = JaxEngine(JaxConfig(**CFG), world["variables"],
                           JaxVocab(UNITS), jax_parse_cmvn(cmvn_path),
                           phonetic=StubPhonetic(), decode_type="greedy")
    engine = InferenceEngine(ModelConfig(**CFG), world["state"],
                             Vocab(UNITS), parse_kaldi_cmvn_text(cmvn_path),
                             phonetic=StubPhonetic(), device="cpu")
    return jax_engine, engine


_FIELDS = ("status", "id", "word", "score", "correct", "total",
           "canonical_row", "ops_row", "decoded_row", "insertion_faults",
           "substitution_faults", "deletion_faults", "ipa", "translation",
           "phonics", "batch", "error")


def test_handle_requests_matches_jax(world):
    """Same lines, same responses: scores, display rows, fault lists and
    per-request errors; only the wall-clock fields differ."""
    jax_engine, engine = _engines(world)
    lines = _requests(world["paths"])
    ref = jax_handle_requests(jax_engine, lines)
    ours = handle_requests(engine, lines)
    assert [r["status"] for r in ours].count("ok") == 8
    for a, b in zip(ours, ref):
        assert {k: a.get(k) for k in _FIELDS} == {k: b.get(k) for k in _FIELDS}
    # one forward per length bucket: 32, 64, 128 and 160 model frames
    assert engine.session.forwards == 4


def test_batched_and_single_word_diagnoses_agree(world):
    _, engine = _engines(world)
    from mdd_tpu_torch.frontend.wav import read_audio

    wav = read_audio(world["paths"][3])[0]
    single = engine.diagnose_word("u", wav, "w", ["m", "aa"])
    batched = engine.diagnose_words(
        [(f"u{i}", wav, "w", ["m", "aa"]) for i in range(5)])
    assert all(dataclasses.replace(d, utt_id="u") == single for d in batched)


def test_request_without_canonical_gets_an_error(world):
    """The name dates from before the port had a lexicon, when a request
    without "canonical" got an error.  Now the lexicon derives the phones
    from the word: such a request is answered like mdd_tpu's, field for
    field (ipa, translation and phonics included), both engines on their
    own `Phonetic` over one dictionary.  A "canonical" that is present but
    not a non-empty list of strings still gets an error."""
    from mdd_tpu.lexicon.dictionary import Phonetic as JaxPhonetic
    from mdd_tpu_torch.lexicon.dictionary import Phonetic

    cmvn_path = str(world["root"] / "cmvn.txt")
    lexicon = (world["asset_dir"], world["ecdict"])
    jax_engine = JaxEngine(JaxConfig(**CFG), world["variables"],
                           JaxVocab(UNITS), jax_parse_cmvn(cmvn_path),
                           phonetic=JaxPhonetic(*lexicon),
                           decode_type="greedy")
    engine = InferenceEngine(ModelConfig(**CFG), world["state"],
                             Vocab(UNITS), parse_kaldi_cmvn_text(cmvn_path),
                             phonetic=Phonetic(*lexicon), device="cpu")
    word_only = [json.dumps({"id": 7, "wav": world["paths"][i], "word": w})
                 for i, w in ((0, "about"), (2, "magazine"), (3, "zxqj"))]
    resps = handle_requests(engine, word_only)
    ref = jax_handle_requests(jax_engine, word_only)
    for a, b in zip(resps, ref):
        assert {k: a.get(k) for k in _FIELDS} == {k: b.get(k) for k in _FIELDS}
    assert [r["status"] for r in resps] == ["ok"] * 3
    assert resps[0]["id"] == 7 and resps[0]["ipa"].startswith("英: /")
    assert resps[0]["translation"] and resps[0]["phonics"]
    bad = json.dumps({"id": 8, "wav": world["paths"][0], "word": "a",
                      "canonical": []})
    resp = handle_requests(engine, [bad])[0]
    assert resp["status"] == "error" and resp["id"] == 8
    assert "canonical" in resp["error"]


def test_serve_loop_answers_every_line_in_order(world):
    _, engine = _engines(world)
    lines = _requests(world["paths"])
    out = io.StringIO()
    n = serve_loop(engine, io.StringIO("\n".join(lines) + "\n"), out)
    resps = [json.loads(l) for l in out.getvalue().splitlines()]
    assert n == len(resps) == len(lines)
    assert [r.get("id") for r in resps if r["status"] == "ok"] == list(
        range(8))


def test_serve_subcommand_on_cpu(world, monkeypatch, capsys):
    root = world["root"]
    save_checkpoint(str(root / "ckpt"), "best", world["state"],
                    {"model_config": dataclasses.asdict(ModelConfig(**CFG))})
    conf = root / "serve.yaml"
    conf.write_text(f"vocab_file: {root / 'units'}\ndecode_type: Beam\n")
    lines = _requests(world["paths"])[:3]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    rc = cli.main(["serve", "--conf", str(conf), "--cmvn",
                   str(root / "cmvn.txt"), "--checkpoint", str(root / "ckpt"),
                   "--dict-dir", world["asset_dir"],
                   "--device", "cpu", "--decode-type", "Greedy", "--quiet"])
    assert rc == 0
    resps = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [r["status"] for r in resps] == ["ok", "ok", "error"]


def test_beam_requests_match_jax_and_serve_yaml_builds_the_beam(world):
    """A request served with the beam (width 4, a bigram LM at alpha 0.5)
    answers like mdd_tpu's, field for field, and through the `serve`
    subcommand the YAML's decode_type, beam_width, lm_path and lm_alpha
    build the beam session."""
    from mdd_tpu_torch.decode.beam_jit import BatchedBeamDecoder
    from mdd_tpu_torch.decode.lm_train import train_phone_lm

    root = world["root"]
    text = root / "phn_text"
    rng = np.random.default_rng(2)
    text.write_text("".join(
        f"u{i} {' '.join(UNITS[k] for k in rng.integers(0, len(UNITS), 6))}\n"
        for i in range(40)))
    arpa = str(root / "lm.arpa")
    train_phone_lm(str(text), arpa)
    cmvn_path = str(root / "cmvn.txt")
    kw = dict(decode_type="Beam", beam_width=4, lm_path=arpa, lm_alpha=0.5)
    jax_engine = JaxEngine(JaxConfig(**CFG), world["variables"],
                           JaxVocab(UNITS), jax_parse_cmvn(cmvn_path),
                           phonetic=StubPhonetic(), **kw)
    engine = InferenceEngine(ModelConfig(**CFG), world["state"],
                             Vocab(UNITS), parse_kaldi_cmvn_text(cmvn_path),
                             phonetic=StubPhonetic(), device="cpu", **kw)
    assert isinstance(engine.session.beam, BatchedBeamDecoder)
    lines = _requests(world["paths"])
    ours = handle_requests(engine, lines)
    ref = jax_handle_requests(jax_engine, lines)
    assert [r["status"] for r in ours].count("ok") == 8
    for a, b in zip(ours, ref):
        assert {k: a.get(k) for k in _FIELDS} == {k: b.get(k) for k in _FIELDS}

    save_checkpoint(str(root / "ckpt_beam"), "best", world["state"],
                    {"model_config": dataclasses.asdict(ModelConfig(**CFG))})
    conf = root / "serve_beam.yaml"
    conf.write_text(f"vocab_file: {root / 'units'}\ndecode_type: Beam\n"
                    f"beam_width: 4\nlm_path: {arpa}\nlm_alpha: 0.5\n")
    built = cli._build_engine(cli.build_parser().parse_args(
        ["serve", "--conf", str(conf), "--cmvn", cmvn_path, "--checkpoint",
         str(root / "ckpt_beam"), "--dict-dir", world["asset_dir"],
         "--no-denoise", "--device", "cpu"]))
    assert not built.session.greedy and built.session.beam.beam_width == 4
    assert built.session.beam.lm_matrix.abs().sum() > 0
    built.phonetic = StubPhonetic()   # the display fields of the lines above
    again = handle_requests(built, lines)
    for a, b in zip(again, ours):
        assert {k: a.get(k) for k in _FIELDS} == {k: b.get(k) for k in _FIELDS}


@pytest.mark.parametrize("name", ["ctc_config", "synthetic_full",
                                  "cnn_rnn_ctc"])
def test_config_loads_as_in_jax(name):
    path = f"conf/{name}.yaml"
    ours, ref = load_config(path), jax_load_config(path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(ours.model_config(43))
            == dataclasses.asdict(ref.model_config(43)))
