"""`evaluate_model` of the port vs mdd_tpu's on the same tiny corpus (written
by tests/test_torch_data.py::write_corpus) and the same weights (initialised
in JAX, bridged with convert.flax_to_torch): the MddReport integers and the
three dump files are equal, for greedy and beam + LM decoding, with the
scorer thread on and off, on the host-spliced and the device front end, with
a ragged tail.  Then the `evaluate`, `mdd-result` and `train-lm` subcommands
end to end on the CPU, and the threads' end when decoding raises."""

import dataclasses
import json
import os
import re
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

from mdd_tpu.data.dataset import BucketedLoader as JaxLoader
from mdd_tpu.data.dataset import SpeechDataset as JaxDataset
from mdd_tpu.data.vocab import Vocab as JaxVocab
from mdd_tpu.evals.evaluate import EvalSession as JaxEvalSession
from mdd_tpu.evals.evaluate import evaluate_model as jax_evaluate_model
from mdd_tpu.models.ctc_model import CTCAttentionModel as JaxModel
from mdd_tpu.models.ctc_model import ModelConfig as JaxConfig
from mdd_tpu_torch import cli
from mdd_tpu_torch.convert import flax_to_torch
from mdd_tpu_torch.data.dataset import BucketedLoader, SpeechDataset
from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.decode.lm_train import train_phone_lm
from mdd_tpu_torch.evals.evaluate import EvalSession, evaluate_model
from mdd_tpu_torch.models.ctc_model import ModelConfig
from mdd_tpu_torch.train.checkpoint import save_checkpoint
from test_torch_data import UNITS, write_corpus

CFG = dict(input_dim=243, num_class=len(UNITS) + 2, conv_channels=(4, 4),
           rnn_hidden_size=16, rnn_layers=2, text_embed_size=8,
           text_vocab_size=len(UNITS) + 4, use_pallas_lstm=True)
ACCENT = ("test_000",)       # utterances test_0000 .. test_0009
DUMPS = ("decode_seq.log", "human_seq.log", "transcribe.log")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaluate")
    corpus = write_corpus(root / "data", "test", 11, seed=5)
    train = write_corpus(root / "data", "train", 30, seed=6)
    arpa = str(root / "lm.arpa")
    assert train_phone_lm(train[1], arpa) == 30
    variables = jax.device_get(JaxModel(JaxConfig(**CFG)).init(
        jax.random.key(0), np.zeros((1, 16, 243), np.float32),
        np.zeros((1, 4), np.int32), np.asarray([4], np.int32)))
    return dict(root=root, corpus=corpus, arpa=arpa, variables=variables,
                state=flax_to_torch(variables["params"],
                                    variables["batch_stats"]))


def _sessions(world, decode_type, device_frontend):
    kw = dict(decode_type=decode_type, beam_width=4, lm_path=world["arpa"],
              lm_alpha=0.5, device_frontend=device_frontend)
    return (JaxEvalSession(JaxConfig(**CFG), world["variables"],
                           JaxVocab(UNITS), **kw),
            EvalSession(ModelConfig(**CFG), world["state"], Vocab(UNITS),
                        device="cpu", **kw))


def _loaders(world, batch_size, device_frontend):
    out = []
    for ds_cls, loader_cls, vocab in ((JaxDataset, JaxLoader, JaxVocab),
                                      (SpeechDataset, BucketedLoader, Vocab)):
        ds = ds_cls(vocab(UNITS), *world["corpus"],
                    device_frontend=device_frontend)
        out.append(loader_cls(
            ds, batch_size=batch_size, shuffle=False, time_quantum=16,
            wire_dtype="bfloat16" if device_frontend else None))
    return out


def _ints(rep):
    d = dataclasses.asdict(rep)
    d.pop("decode_minutes")
    return d


@pytest.mark.parametrize("decode_type,device_frontend,batch_size,overlap", [
    ("greedy", False, 4, True),
    ("greedy", True, 4, False),
    ("greedy", True, 16, True),      # one ragged batch of 11 -> ladder 16
    ("Beam", True, 4, True),
    ("Beam", False, 4, False),
])
def test_evaluate_model_equals_jax(world, tmp_path, decode_type,
                                   device_frontend, batch_size, overlap):
    """Same counts, same dump files.  The log-probs of the two packages
    differ by float32 summation order (1e-4, tests/test_torch_model.py);
    on this corpus no decoded sequence sits that close to a tie."""
    jax_session, session = _sessions(world, decode_type, device_frontend)
    jax_loader, loader = _loaders(world, batch_size, device_frontend)
    lines = []
    ref = jax_evaluate_model(jax_session, jax_loader, ACCENT,
                             dump_dir=str(tmp_path / "jax"),
                             log=lambda *_: None, overlap_scoring=overlap)
    ours = evaluate_model(session, loader, ACCENT,
                          dump_dir=str(tmp_path / "torch"),
                          log=lines.append, overlap_scoring=overlap)
    assert _ints(ours) == _ints(ref)
    assert ours.n_utts == 11 and ours.accent_tokens > 0 and ours.tokens > 0
    for name in DUMPS:
        assert ((tmp_path / "torch" / name).read_text()
                == (tmp_path / "jax" / name).read_text()), name
    assert "Phoneme error rate on test set" in lines[0]
    assert session.forwards == -(-11 // batch_size)


def test_metrics_do_not_depend_on_batching_or_the_scorer_thread(world):
    """Ragged tails up the pow-2 ladder, exact batches of 1, scorer thread
    on and off, and the host beam: one report."""
    _, session = _sessions(world, "Beam", True)
    reports = []
    for batch_size, overlap in ((16, True), (1, False), (4, True)):
        _, loader = _loaders(world, batch_size, True)
        reports.append(_ints(evaluate_model(
            session, loader, ACCENT, log=lambda *_: None,
            overlap_scoring=overlap)))
    assert reports[0] == reports[1] == reports[2]
    host = EvalSession(ModelConfig(**CFG), world["state"], Vocab(UNITS),
                       decode_type="Beam", beam_width=4,
                       lm_path=world["arpa"], lm_alpha=0.5, host_beam=True,
                       device="cpu", device_frontend=True)
    _, loader = _loaders(world, 4, True)
    assert _ints(evaluate_model(host, loader, ACCENT,
                                log=lambda *_: None)) == reports[0]


def test_threads_end_when_decoding_raises(world):
    """The scorer and staging threads are ended on a failure in the loop
    (mdd_tpu's evaluate_model leaves its scorer thread waiting)."""
    _, session = _sessions(world, "greedy", True)
    _, loader = _loaders(world, 4, True)
    calls = []
    real = session.decode_staged

    def failing(staged):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("decode failed")
        return real(staged)

    session.decode_staged = failing
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="decode failed"):
        evaluate_model(session, loader, ACCENT, log=lambda *_: None)
    for thread in set(threading.enumerate()) - before:
        thread.join(timeout=5)
        assert not thread.is_alive()


def test_scorer_error_surfaces(world, monkeypatch):
    from mdd_tpu_torch.evals import evaluate as mod

    _, session = _sessions(world, "greedy", False)
    _, loader = _loaders(world, 4, False)

    def broken(*_):
        raise ValueError("scoring failed")

    monkeypatch.setattr(mod, "score_mdd", broken)
    before = set(threading.enumerate())
    with pytest.raises(ValueError, match="scoring failed"):
        evaluate_model(session, loader, ACCENT, log=lambda *_: None)
    assert not [t for t in set(threading.enumerate()) - before
                if t.is_alive() and (t.join(timeout=5) or t.is_alive())]


@pytest.fixture(scope="module")
def conf(world):
    root = world["root"]
    save_checkpoint(str(root / "ckpt" / "tiny"), "best", world["state"],
                    {"model_config": dataclasses.asdict(ModelConfig(**CFG))})
    (root / "units").write_text("\n".join(UNITS) + "\n")
    scp, lab, trans = world["corpus"]
    fields = dict(
        exp_name="tiny", checkpoint_dir=str(root / "ckpt"),
        vocab_file=str(root / "units"), test_scp_path=scp,
        test_lab_path=lab, test_trans_path=trans, decode_type="Beam",
        beam_width=4, lm_alpha=0.5, lm_path=world["arpa"],
        device_frontend=True, wire_dtype="bfloat16", batch_size=4,
        num_workers=2, time_quantum=16, label_quantum=4)
    path = root / "eval.yaml"
    path.write_text("".join(f"{k}: {json.dumps(v)}\n"
                            for k, v in fields.items()))
    return str(path)


def _per(text):
    return float(re.search(r"Phoneme error rate on test set: (\S+)",
                           text).group(1))


def test_evaluate_and_mdd_result_subcommands(world, conf, tmp_path, capsys):
    """`evaluate --device cpu` (beam + LM from the YAML, then greedy by
    flag) and `mdd-result` on its dumps: the report parses, TA + FR + FA +
    TR covers the canonical phones, and mdd-result's PER is evaluate's."""
    dump = tmp_path / "dump"
    assert cli.main(["evaluate", "--conf", conf, "--device", "cpu",
                     "--dump-dir", str(dump)]) == 0
    beam = capsys.readouterr().out
    total, parts = map(int, re.search(r"total :  (\d+) (\d+)", beam).groups())
    assert parts >= total > 0        # an insertion adds a count, no slot
    session = EvalSession(
        ModelConfig(**CFG), world["state"], Vocab(UNITS), decode_type="Beam",
        beam_width=4, lm_path=world["arpa"], lm_alpha=0.5, device="cpu",
        device_frontend=True)
    _, loader = _loaders(world, 4, True)
    want = evaluate_model(session, loader, log=lambda *_: None)
    assert _per(beam) == pytest.approx(want.per, abs=1e-4)
    assert total == want.counts.total_canonical_phones == sum(
        len(line.split()) - 1 for line in
        (dump / "transcribe.log").read_text().splitlines())
    assert "time used for decode 11 sentences" in beam

    assert cli.main(["evaluate", "--conf", conf, "--device", "cpu",
                     "--decode-type", "Greedy", "--lm-alpha", "0"]) == 0
    assert "Phoneme error rate" in capsys.readouterr().out

    assert cli.main(["mdd-result", "--ref", str(dump / "transcribe.log"),
                     "--human", str(dump / "human_seq.log"),
                     "--hyp", str(dump / "decode_seq.log"),
                     "--detail-dir", str(tmp_path / "detail")]) == 0
    out = capsys.readouterr().out
    wer = re.search(r"%WER (\S+) \[ (\d+) / (\d+),", out)
    assert (int(wer.group(2)), int(wer.group(3))) == (want.errors,
                                                      want.tokens)
    assert "Recall:" in out and (tmp_path / "detail" / "ref_our_ops").exists()


@pytest.mark.parametrize("flag", ["--cached", "--distributed"])
def test_scale_out_flags_are_refused(conf, flag, tmp_path):
    """--distributed is ported (tests/test_torch_distributed_cli.py) and
    refused without torchrun's environment; --cached is ported
    (tests/test_torch_device_cache.py) and refused without the device
    front end, whose raw features the cache holds."""
    if flag == "--cached":
        host = tmp_path / "host.yaml"
        host.write_text(Path(conf).read_text().replace(
            "device_frontend: true", "device_frontend: false").replace(
            'wire_dtype: "bfloat16"', 'wire_dtype: ""'))
        conf, match = str(host), "requires device_frontend"
    else:
        for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT"):
            assert v not in os.environ
        match = "torchrun's environment: RANK, WORLD_SIZE"
    with pytest.raises(SystemExit, match=match):
        cli.main(["evaluate", "--conf", conf, "--device", "cpu", flag])


def test_evaluate_runs_on_the_card_unless_asked():
    args = cli.build_parser().parse_args(["evaluate", "--conf", "x.yaml"])
    assert args.device == "cuda" and args.decode_type is None


def test_train_lm_subcommand(world, tmp_path, capsys):
    out = tmp_path / "lm.arpa"
    assert cli.main(["train-lm", "--phn-text", world["corpus"][1],
                     "--out", str(out)]) == 0
    assert "trained bigram LM on 11 sentences" in capsys.readouterr().out
    assert out.read_text().startswith("\\data\\")
