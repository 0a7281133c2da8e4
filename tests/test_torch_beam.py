"""The port's decoders vs mdd_tpu's on the same numpy inputs: the ARPA
loader's dense matrix and the LM trainer's file (to the last bit / byte),
the host prefix beam (identical sequences), and the batched device beam
against both mdd_tpu's BatchedBeamDecoder and the host beam on the six
scenarios of tests/test_beam_jit.py."""

import numpy as np
import pytest
import torch

from mdd_tpu.align.levenshtein import edit_distance
from mdd_tpu.data.vocab import Vocab as JaxVocab
from mdd_tpu.decode import lm_train as jax_lm_train
from mdd_tpu.decode.arpa import ArpaBigramLM as JaxArpa
from mdd_tpu.decode.beam import BeamSearchDecoder as JaxHostBeam
from mdd_tpu.decode.beam_jit import BatchedBeamDecoder as JaxBatchedBeam
from mdd_tpu.decode.greedy import greedy_decode as jax_greedy_decode
from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.decode import beam_jit, lm_train
from mdd_tpu_torch.decode.arpa import ArpaBigramLM, UniformLM
from mdd_tpu_torch.decode.beam import BeamSearchDecoder
from mdd_tpu_torch.decode.beam_jit import BatchedBeamDecoder
from mdd_tpu_torch.ops import beam_cuda

UNITS = ["sil", "aa", "bb", "cc", "dd"]


def _random_probs(rng, b, t, c, blank_boost=0.0):
    logits = rng.standard_normal((b, t, c)).astype(np.float32)
    logits[:, :, 0] += blank_boost
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _sentences(seed, units, n=50):
    rng = np.random.default_rng(seed)
    return [[units[i] for i in rng.integers(0, len(units),
                                            rng.integers(2, 8))]
            for _ in range(n)]


@pytest.fixture(scope="module")
def arpa_path(tmp_path_factory):
    """An ARPA file trained by the port on seeded sentences."""
    path = tmp_path_factory.mktemp("lm") / "lm.arpa"
    counts = lm_train.BigramCounts()
    counts.add_corpus(_sentences(3, JaxVocab(UNITS).units()))
    lm_train.write_arpa(*lm_train.witten_bell_bigram(counts), str(path))
    return str(path)


def test_write_arpa_equals_jax_byte_for_byte(tmp_path, arpa_path):
    counts = jax_lm_train.BigramCounts()
    counts.add_corpus(_sentences(3, JaxVocab(UNITS).units()))
    ref = tmp_path / "ref.arpa"
    jax_lm_train.write_arpa(*jax_lm_train.witten_bell_bigram(counts),
                            str(ref))
    assert open(arpa_path, "rb").read() == ref.read_bytes()


def test_train_phone_lm_equals_jax(tmp_path):
    text = tmp_path / "phn_text"
    text.write_text("".join(f"u{i} {' '.join(s)}\n" for i, s in
                            enumerate(_sentences(5, UNITS[1:], 20))))
    n = lm_train.train_phone_lm(str(text), str(tmp_path / "a.arpa"))
    n_ref = jax_lm_train.train_phone_lm(str(text), str(tmp_path / "b.arpa"))
    assert n == n_ref == 20
    assert ((tmp_path / "a.arpa").read_bytes()
            == (tmp_path / "b.arpa").read_bytes())


def test_dense_matrix_and_bi_prob_equal_jax(arpa_path):
    vocab = Vocab(UNITS)
    ours, ref = ArpaBigramLM(arpa_path), JaxArpa(arpa_path)
    np.testing.assert_array_equal(ours.dense_matrix(vocab.index2word),
                                  ref.dense_matrix(vocab.index2word))
    words = JaxVocab(UNITS).units() + [""]
    for w1 in words:
        for w2 in words:
            assert ours.bi_prob(w1, w2) == ref.bi_prob(w1, w2)
    assert ours.score_sentence(["aa", "bb"]) == ref.score_sentence(
        ["aa", "bb"])
    assert not UniformLM().dense_matrix(vocab.index2word).any()


# the six scenarios of tests/test_beam_jit.py: (seed, B, T, blank boost,
# lengths, beam width, with LM)
SCENARIOS = {
    "no_lm": (0, 8, 24, 0.0, [24, 20, 24, 5, 24, 17, 24, 1], 4, False),
    "blank_heavy": (1, 6, 30, 2.5, [30] * 6, 4, False),
    "wide_beam": (2, 4, 16, 0.0, [16] * 4, 10, False),
    "with_lm": (3, 6, 20, 0.0, [20] * 6, 5, True),
    "empty_and_padded": (5, 2, 12, 0.0, [0, 12], 4, False),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_beams_return_identical_sequences(name, arpa_path):
    """Host beam == mdd_tpu's host beam; device beam == mdd_tpu's jit beam
    == host beam.  No tolerance: the sequences are equal."""
    seed, b, t, boost, lengths, width, with_lm = SCENARIOS[name]
    vocab = Vocab(UNITS)
    probs = _random_probs(np.random.default_rng(seed), b, t, vocab.n_words,
                          boost)
    kw = dict(beam_width=width)
    jax_kw = dict(kw)
    if with_lm:
        kw.update(lm=ArpaBigramLM(arpa_path), lm_alpha=0.5)
        jax_kw.update(lm=JaxArpa(arpa_path), lm_alpha=0.5)
    host = BeamSearchDecoder(vocab.index2word, **kw).decode(probs, lengths)
    assert host == JaxHostBeam(vocab.index2word, **jax_kw).decode(probs,
                                                                  lengths)
    device = BatchedBeamDecoder(vocab.index2word, device="cpu", **kw)
    got = device.decode(probs, lengths)
    assert got == JaxBatchedBeam(vocab.index2word, **jax_kw).decode(probs,
                                                                    lengths)
    if name != "empty_and_padded":      # the host beam takes length >= 1
        assert got == host
    else:
        assert got[0] == []
        # same content, shorter padding -> same answer
        assert got[1] == device.decode(probs[1:2, :12], [12])[0]
    assert device.decode_phones(probs, lengths) == [
        [vocab.index2word[i] for i in s] for s in got]
    assert device.decode_log(np.log(probs), lengths) == got


def test_beam_search_sends_cpu_tensors_to_the_plain_version(arpa_path,
                                                          monkeypatch):
    """BatchedBeamDecoder's dispatcher on CPU tensors: the plain loop, no
    launch, and mdd_tpu's sequences (scenario with_lm's inputs)."""
    def refuse(*_, **__):
        raise AssertionError("a CPU tensor reached the beam kernel")
    monkeypatch.setattr(beam_jit, "ctc_beam_kernel", refuse)
    seed, b, t, boost, lengths, width, _ = SCENARIOS["with_lm"]
    vocab = Vocab(UNITS)
    probs = _random_probs(np.random.default_rng(seed), b, t, vocab.n_words,
                          boost)
    got = BatchedBeamDecoder(vocab.index2word, beam_width=width,
                             lm=ArpaBigramLM(arpa_path), lm_alpha=0.5,
                             device="cpu").decode(probs, lengths)
    assert got == JaxBatchedBeam(vocab.index2word, beam_width=width,
                                 lm=JaxArpa(arpa_path), lm_alpha=0.5).decode(
        probs, lengths)
    lp = torch.log(torch.from_numpy(probs).clamp_min(1e-38))
    lm = torch.from_numpy(np.asarray(ArpaBigramLM(arpa_path).dense_matrix(
        vocab.index2word) * 0.5, np.float32))
    args = (lp, torch.tensor(lengths), lm, width, 0, 0.1)
    out, want = beam_jit.beam_search(*args), beam_jit.beam_search_batch(*args)
    assert all(torch.equal(x, y) for x, y in zip(out, want))


@pytest.mark.parametrize("with_lm", [False, True])
@pytest.mark.parametrize("n_units,width", [(5, 10), (5, 4), (41, 10)])
def test_merge_finds_at_most_one_extension_per_stay(with_lm, n_units, width,
                                                    monkeypatch):
    """The property the kernel's merge relies on, in the plain version:
    every column of the (K*C, K) collision matrix m (read where the
    masked log-sum-exp sees it: the entries that are not -inf) holds at
    most one True, so a stay gains from one extension at most."""
    rng = np.random.default_rng(n_units + width + with_lm)
    c = n_units + 2
    lp = torch.from_numpy(rng.standard_normal((4, 30, c)).astype(
        np.float32)).log_softmax(-1)
    lm = (torch.from_numpy((np.log(rng.dirichlet(np.ones(c + 1), c + 1))
                            * 0.5).astype(np.float32)) if with_lm
          else torch.zeros(c + 1, c + 1))
    columns = []
    logsumexp = torch.logsumexp

    def seen(x, dim):
        columns.append((x > -float("inf")).sum(dim=dim).max().item())
        return logsumexp(x, dim=dim)
    monkeypatch.setattr(torch, "logsumexp", seen)
    beam_jit.beam_search_batch(lp, torch.tensor([30, 30, 17, 1]), lm, width,
                               0, 0.1)
    assert len(columns) == 30 and max(columns) <= 1 and max(columns) == 1


_GOOD_BEAM = dict(log_probs=torch.zeros((2, 6, 7)),
                  lengths=torch.full((2,), 6, dtype=torch.int64),
                  lm_matrix=torch.zeros((8, 8)), beam_width=4, blank=0)


@pytest.mark.parametrize("bad,error,match", [
    (dict(log_probs=torch.zeros((2, 6, 7), dtype=torch.float64)), TypeError,
     "log_probs"),
    (dict(lengths=torch.full((2,), 6, dtype=torch.int32)), TypeError,
     "lengths"),
    (dict(log_probs=torch.zeros((6, 2, 7)).transpose(0, 1)), ValueError,
     "contiguous"),
    (dict(lengths=torch.full((3,), 6, dtype=torch.int64)), ValueError,
     "lengths must be"),
    (dict(beam_width=17), ValueError, "beam width"),
    (dict(beam_width=0), ValueError, "beam width"),
    (dict(log_probs=torch.zeros((2, 6, 65)), lm_matrix=torch.zeros((66, 66))),
     ValueError, "classes"),
    (dict(lm_matrix=torch.zeros((6, 6))), ValueError, "LM matrix"),
    (dict(lm_matrix=torch.zeros((8, 9))), ValueError, "LM matrix"),
    (dict(blank=7), ValueError, "blank"),
    ({}, ValueError, "CUDA tensors"),
])
def test_beam_kernel_wrapper_refuses_on_the_cpu(bad, error, match):
    """Every refusal of the kernel's wrapper shows on CPU tensors, before
    any build or launch (the device is checked last): K <= 16, C <= 64,
    a square LM matrix of side C to 65."""
    kernel = beam_cuda.CtcBeamKernel()
    args = {**_GOOD_BEAM, **bad}
    with pytest.raises(error, match=match):
        kernel(args["log_probs"], args["lengths"], args["lm_matrix"],
               args["beam_width"], args["blank"], 0.1)
    assert kernel.launches == 0 and kernel._lib is None


def test_peaky_probabilities_decode_as_greedy():
    vocab = Vocab(UNITS)
    rng = np.random.default_rng(4)
    t, c = 15, vocab.n_words
    ids = rng.integers(0, c, t)
    probs = np.full((t, c), 1e-5, np.float32)
    probs[np.arange(t), ids] = 1.0
    probs /= probs.sum(-1, keepdims=True)
    beam = BatchedBeamDecoder(vocab.index2word, beam_width=4,
                              device="cpu").decode(
        probs[None], [t])[0]
    greedy = jax_greedy_decode(np.log(probs)[:, None, :], np.asarray([t]))[0]
    assert beam == greedy
    assert beam == BeamSearchDecoder(vocab.index2word, beam_width=4).decode(
        probs[None], [t])[0]


def test_statistical_agreement_at_scale():
    """At realistic scale (C=43, T=150, K=10, B=16) float32 accumulation
    can reorder near-tied beams versus the float64 host decoder: at least
    15 of 16 sequences identical and token error < 0.002, the bar
    tests/test_beam_jit.py sets for mdd_tpu's jit beam; against that jit
    beam (float32 like ours) the same bar."""
    vocab = Vocab([f"p{i}" for i in range(41)])
    rng = np.random.default_rng(0)
    B, T, C = 16, 150, vocab.n_words
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    logits[:, :, 0] += 1.5
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ours = BatchedBeamDecoder(vocab.index2word, beam_width=10,
                              device="cpu").decode(
        probs, [T] * B)
    for other in (
            BeamSearchDecoder(vocab.index2word, beam_width=10),
            JaxBatchedBeam(vocab.index2word, beam_width=10)):
        want = other.decode(probs, [T] * B)
        exact = sum(x == y for x, y in zip(ours, want))
        errs = sum(edit_distance(x, y)[0] for x, y in zip(ours, want))
        assert exact >= B - 1
        assert errs / sum(len(y) for y in want) < 0.002


def test_int32_hashes_wrap_like_numpy():
    """The rolling hashes rely on wrap-around int32 products."""
    h = torch.tensor([2147483647, -2147483648, 123456789, -2],
                     dtype=torch.int32)
    labels = torch.arange(4, dtype=torch.int32)
    with np.errstate(over="ignore"):
        for mul in (beam_jit._MUL1, beam_jit._MUL2):
            got = h[:, None] * mul + labels + 1
            want = (h.numpy()[:, None] * np.int32(mul)
                    + labels.numpy() + np.int32(1))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


def test_all_false_merge_column_and_neg_inf_stay_finite():
    """logsumexp over an all-masked column is -inf, logaddexp with it
    returns the other operand, and NEG_INF never turns into NaN."""
    neg = torch.tensor([beam_jit.NEG_INF, -3.0])
    gain = torch.logsumexp(torch.full((5, 2), -float("inf")), dim=0)
    assert torch.isinf(gain).all()
    out = torch.logaddexp(neg, gain)
    assert torch.equal(out, neg)
    assert torch.equal(torch.logaddexp(neg, neg)[:1], neg[:1])


def test_stable_descending_sort_puts_the_lowest_index_first():
    """The tie order of jax.lax.top_k, which the K-best step relies on."""
    x = torch.tensor([[beam_jit.NEG_INF, 1.0, beam_jit.NEG_INF, 1.0, 2.0,
                       beam_jit.NEG_INF]])
    pos = torch.sort(x, dim=1, descending=True, stable=True).indices
    assert pos.tolist() == [[4, 1, 3, 0, 2, 5]]
