"""The port's host-side scoring vs mdd_tpu's on seeded random phone
strings: both alignment families, slot accounting (TA/FR/FA/TR), the
forgiveness tiers, score_mdd, corpus WER and its report, the per-utterance
detail files and the hierarchical three-way analysis.  Everything here is
integer or string work, so the outputs are equal, not close."""

import dataclasses

import numpy as np
import pytest

from mdd_tpu.align import levenshtein as jax_lev
from mdd_tpu.align import mdd as jax_mdd
from mdd_tpu.evals import analysis as jax_analysis
from mdd_tpu.evals import evaluate as jax_evaluate
from mdd_tpu.evals import wer as jax_wer
from mdd_tpu_torch.align import levenshtein as lev
from mdd_tpu_torch.align import mdd
from mdd_tpu_torch.evals import analysis, evaluate, wer

PHONES = ["sil", "aa", "ae", "ah", "b", "d", "eh", "iy", "k", "s", "t", "z"]


def _corrupt(rng, seq, p):
    """Substitute, delete and insert phones with probability p each."""
    out = []
    for tok in seq:
        r = rng.random()
        if r < p:
            out.append(PHONES[rng.integers(1, len(PHONES))])
        elif r < 2 * p:
            continue
        else:
            out.append(tok)
        if rng.random() < p:
            out.append(PHONES[rng.integers(1, len(PHONES))])
    return out


def _corpus(seed, n=40):
    """{utt: phones} for canonical, human label and decoder output; every
    third utterance carries the accent prefix."""
    rng = np.random.default_rng(seed)
    ref, human, hyp = {}, {}, {}
    for i in range(n):
        utt = f"TXHC_u{i}" if i % 3 == 0 else f"u{i}"
        canon = ["sil"] + [PHONES[k] for k in rng.integers(
            1, len(PHONES), rng.integers(1, 14))] + ["sil"]
        ref[utt] = canon
        human[utt] = _corrupt(rng, canon, 0.12)
        hyp[utt] = _corrupt(rng, human[utt], 0.15)
    hyp["u1"] = []                       # an empty hypothesis
    return ref, human, hyp


@pytest.fixture(scope="module", params=[0, 1, 2])
def corpus(request):
    return _corpus(request.param)


def test_both_alignment_families_equal(corpus):
    ref, human, hyp = corpus
    for utt in ref:
        for a, b in ((hyp[utt], human[utt]), (human[utt], ref[utt])):
            assert lev.align(a, b) == jax_lev.align(a, b)
            assert (lev.kaldi_edit_distance(b, a)
                    == jax_lev.kaldi_edit_distance(b, a))
            pairs = lev.kaldi_alignment(b, a)
            assert pairs == jax_lev.kaldi_alignment(b, a)
            assert lev.alignment_ops(pairs) == jax_lev.alignment_ops(pairs)


def test_slot_accounting_equals(corpus):
    ref, human, hyp = corpus
    for accumulate, jax_accumulate in (
            (mdd.mdd_accumulate, jax_mdd.mdd_accumulate),
            (mdd.mdd_accumulate_subset, jax_mdd.mdd_accumulate_subset)):
        ours, theirs = mdd.MddCounts(), jax_mdd.MddCounts()
        for utt in ref:
            slots = []
            for m, l in ((mdd, lev), (jax_mdd, jax_lev)):
                d1 = m.alignment_to_slots(
                    human[utt], ref[utt], l.align(human[utt], ref[utt])[1])
                d2 = m.alignment_to_slots(
                    hyp[utt], ref[utt], l.align(hyp[utt], ref[utt])[1])
                slots.append((d1, d2))
            assert slots[0] == slots[1]
            accumulate(*slots[0], ours)
            jax_accumulate(*slots[1], theirs)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert (ours.true_rejection, ours.precision, ours.recall, ours.f1) == (
            theirs.true_rejection, theirs.precision, theirs.recall,
            theirs.f1)
        merged = ours.merge(ours)
        assert merged.true_accept == 2 * ours.true_accept


def _slots(hyp, canonical):
    return mdd.alignment_to_slots(hyp, canonical,
                                  lev.align(hyp, canonical)[1])


# the cases of tests/test_mdd_scoring.py::test_mdd_accounting_cases:
# (label, decoded, canonical) -> the fields that case pins
ACCOUNTING_CASES = [
    (["a", "b", "c"], ["a", "x", "c"], ["a", "b", "c"],
     dict(true_accept=2, false_rejection=1, false_accept=0)),
    (["a", "x", "c"], ["a", "x", "c"], ["a", "b", "c"],
     dict(tr_correct_diag=1, true_accept=2)),
    (["a", "x", "c"], ["a", "y", "c"], ["a", "b", "c"],
     dict(tr_wrong_diag=1)),
    (["a", "x", "c"], ["a", "b", "c"], ["a", "b", "c"],
     dict(false_accept=1)),
    (["a", "q", "b"], ["a", "q", "b"], ["a", "b"],
     dict(tr_correct_diag=1, false_accept=0, false_rejection=0)),
]


@pytest.mark.parametrize("label,decoded,canonical,want", ACCOUNTING_CASES)
def test_mdd_accounting_cases(label, decoded, canonical, want):
    c = mdd.MddCounts()
    mdd.mdd_accumulate(_slots(label, canonical), _slots(decoded, canonical), c)
    assert {k: getattr(c, k) for k in want} == want


def test_alignment_to_slots_basic():
    d = _slots(["a", "x", "c"], ["a", "b", "c"])
    assert d[0] == "-" and d[1] == "Sx" and d[2] == "-" and d["I"] == []
    assert _slots(["a", "c"], ["a", "b", "c"])[1] == "D"
    assert _slots(["a", "x", "b"], ["a", "b"])["I"] == ["01"]


def test_product_diagnosis_cases():
    """tests/test_mdd_scoring.py:74-101 on the port: placeholders and the
    leading-insertion trim."""
    canonical = ["a", "b", "c"]
    for decoded in (["a", "x", "c"], ["a", "c"], ["s", "s", "a", "b", "c"]):
        ops = lev.align(decoded, canonical)[1]
        got = mdd.align_canonical_decoded(decoded, canonical, ops)
        assert got == jax_mdd.align_canonical_decoded(decoded, canonical, ops)
        assert len(got[0]) == len(got[1]) == len(got[2])
        assert mdd.fault_statistics(got[2], got[1], got[0]) == (
            jax_mdd.fault_statistics(got[2], got[1], got[0]))
    d, c, l = mdd.align_canonical_decoded(
        ["s", "s", "k", "ae", "t"], ["k", "ae", "t"],
        lev.align(["s", "s", "k", "ae", "t"], ["k", "ae", "t"])[1])
    assert l.count("I") == 1


@pytest.mark.parametrize("level", [0, 1, 2])
def test_forgiveness_equals(level):
    assert mdd.forgiveness_pairs(level) == jax_mdd.forgiveness_pairs(level)
    decoded = ["eh", "k", "s", "D", "ih"]
    canonical = ["ae", "t", "z", "m", "iy"]
    ops = ["S", "S", "S", "D", "S"]
    assert mdd.apply_forgiveness(decoded, canonical, ops, level) == (
        jax_mdd.apply_forgiveness(decoded, canonical, ops, level))
    assert mdd.G_PAIRS == jax_mdd.G_PAIRS


def test_score_mdd_and_its_report_equal(corpus):
    ref, human, hyp = corpus
    triples = [(u, hyp[u], human[u], ref[u]) for u in ref]
    ours = evaluate.score_mdd(triples)
    theirs = jax_evaluate.score_mdd(triples)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.accent_tokens > 0 and ours.per == theirs.per
    assert (evaluate.format_mdd_report(ours)
            == jax_evaluate.format_mdd_report(theirs))
    vec = evaluate.report_to_vector(ours)
    np.testing.assert_array_equal(vec, jax_evaluate.report_to_vector(theirs))
    assert dataclasses.asdict(evaluate.report_from_vector(vec)) == (
        dataclasses.asdict(ours))
    kept = evaluate.score_mdd(triples, strip_sil=False)
    assert dataclasses.asdict(kept) == dataclasses.asdict(
        jax_evaluate.score_mdd(triples, strip_sil=False))


@pytest.mark.parametrize("n,batch,n_dev,want", [
    (1, 512, 1, 1), (1, 512, 8, 8), (5, 512, 8, 8), (9, 512, 8, 16),
    (300, 512, 8, 512), (3, 4, 1, 4)])
def test_ladder_size(n, batch, n_dev, want):
    assert evaluate._ladder_size(n, batch, n_dev) == want
    assert jax_evaluate._ladder_size(n, batch, n_dev) == want


def test_corpus_wer_and_report_equal(corpus, tmp_path):
    ref, human, hyp = corpus
    hyp = {u: v for u, v in hyp.items() if u != "u2"}    # one absent
    ours, theirs = wer.corpus_wer(human, hyp), jax_wer.corpus_wer(human, hyp)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.absent_sentences == 1 and ours.errors > 0
    assert wer.format_per_report(ours) == jax_wer.format_per_report(theirs)
    path = tmp_path / "trn"
    path.write_text("".join(f"{u} {' '.join(v)}\n" for u, v in human.items()))
    assert wer.read_trn(str(path)) == jax_wer.read_trn(str(path))


def test_analysis_and_detail_files_equal(corpus, tmp_path):
    ref, human, hyp = corpus
    ours = analysis.hierarchical_mdd_analysis(ref, human, hyp)
    theirs = jax_analysis.hierarchical_mdd_analysis(ref, human, hyp)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.report() == theirs.report()
    assert ours.cor + ours.sub + ours.delete == sum(len(v)
                                                    for v in ref.values())
    logs = ([], [])
    for mod, out, log in ((analysis, "ours", logs[0]),
                          (jax_analysis, "theirs", logs[1])):
        mod.mdd_result(ref, human, hyp, out_dir=str(tmp_path / out),
                       log=log.append)
    assert logs[0] == logs[1] and logs[0][0].startswith("%WER")
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert names == ["human_our_detail", "human_our_ops", "ref_human_detail",
                     "ref_human_ops", "ref_our_detail", "ref_our_ops"]
    for name in names:
        assert ((tmp_path / "ours" / name).read_bytes()
                == (tmp_path / "theirs" / name).read_bytes()), name
    counts, text = analysis.wer_ops_details(ref, hyp)
    assert (counts, text) == jax_analysis.wer_ops_details(ref, hyp)
