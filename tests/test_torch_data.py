"""The port's data path vs mdd_tpu's: a tiny corpus written with the port's
ArkScpWriter, read by both packages' kaldi_io and both BucketedLoaders at
one seed (training augmentation on, device front end on, float32 and
bfloat16 wire): batches equal bit for bit."""

import numpy as np
import pytest
import torch

from mdd_tpu.data.dataset import BucketedLoader as JaxLoader
from mdd_tpu.data.dataset import SpeechDataset as JaxDataset
from mdd_tpu.data.dataset import pad_batch_to as jax_pad_batch_to
from mdd_tpu.data.vocab import Vocab as JaxVocab
from mdd_tpu.frontend import augment as jax_augment
from mdd_tpu.frontend import kaldi_io as jax_kaldi_io
from mdd_tpu_torch.data.dataset import BucketedLoader, SpeechDataset
from mdd_tpu_torch.data.dataset import pad_batch_to
from mdd_tpu_torch.data.prefetch import ThreadedLoader
from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.frontend import augment, kaldi_io

UNITS = ["sil", "aa", "ae", "ah", "b", "d", "eh", "iy", "k", "s", "t", "z"]
FEAT_DIM = 81


def write_corpus(root, name, n, seed, min_phones=3, max_phones=8,
                 frames=(3, 7)):
    """`n` utterances of band-template features (frames[0] to frames[1] - 1
    frames a phone) with their phone labels and canonical transcripts;
    -> (scp, lab, trans)."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    scp, lab, trn = (str(root / f"{name}.{s}")
                     for s in ("scp", "phn_text", "trans"))
    with kaldi_io.ArkScpWriter(str(root / f"{name}.ark"), scp) as w, \
            open(lab, "w") as fl, open(trn, "w") as ft:
        for i in range(n):
            utt = f"{name}_{i:04d}"
            phones = ["sil"] + [UNITS[k] for k in rng.integers(
                1, len(UNITS), rng.integers(min_phones, max_phones))] + ["sil"]
            feats = np.concatenate([
                np.repeat(np.sin(np.arange(FEAT_DIM) * (UNITS.index(p) + 1)
                                 / 7.0)[None], rng.integers(*frames),
                          axis=0)
                for p in phones]).astype(np.float32)
            feats += 0.3 * rng.standard_normal(feats.shape).astype(np.float32)
            w.write(utt, feats)
            fl.write(f"{utt} {' '.join(phones)}\n")
            ft.write(f"{utt} {' '.join(phones)}\n")
    return scp, lab, trn


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return write_corpus(root, "train", 22, seed=0)


def test_ark_written_by_the_port_reads_the_same_in_both(corpus):
    scp = corpus[0]
    ours, ref = kaldi_io.read_scp(scp), jax_kaldi_io.read_scp(scp)
    assert ours == ref and len(ours) == 22
    for rx in ours.values():
        np.testing.assert_array_equal(kaldi_io.load_mat(rx),
                                      jax_kaldi_io.load_mat(rx))
    ark = next(iter(ours.values())).rsplit(":", 1)[0]
    for (u1, m1), (u2, m2) in zip(kaldi_io.read_ark(ark),
                                  jax_kaldi_io.read_ark(ark), strict=True):
        assert u1 == u2
        np.testing.assert_array_equal(m1, m2)


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_augmentation_draws_match(mode):
    feats = np.random.default_rng(1).standard_normal((40, FEAT_DIM)).astype(
        np.float32)
    ids = list(range(2, len(UNITS) + 2)) * 3
    ours = (augment.spec_augment(feats, np.random.default_rng(5)),
            augment.mutate_transcript(ids, Vocab(UNITS),
                                      np.random.default_rng(6), 0.5, mode))
    ref = (jax_augment.spec_augment(feats, np.random.default_rng(5)),
           jax_augment.mutate_transcript(ids, JaxVocab(UNITS),
                                         np.random.default_rng(6), 0.5, mode))
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[1] == ref[1] and ours[1] != ids


def _as_f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _assert_batches_equal(ours, ref):
    assert _as_f32(ours.inputs).tobytes() == _as_f32(ref.inputs).tobytes()
    for field in ("input_fracs", "targets", "target_sizes", "trans",
                  "trans_sizes"):
        np.testing.assert_array_equal(getattr(ours, field),
                                      getattr(ref, field), err_msg=field)
    assert ours.utt_ids == ref.utt_ids


def _loaders(corpus, wire_dtype, device_frontend=True):
    kw = dict(train=True, augment_mode=2, mutation_prob=0.3,
              device_frontend=device_frontend)
    ours = BucketedLoader(SpeechDataset(Vocab(UNITS), *corpus, **kw), 4,
                          shuffle=True, seed=7, time_quantum=8,
                          label_quantum=4, wire_dtype=wire_dtype)
    ref = JaxLoader(JaxDataset(JaxVocab(UNITS), *corpus, **kw), 4,
                    shuffle=True, seed=7, time_quantum=8, label_quantum=4,
                    wire_dtype=wire_dtype)
    return ours, ref


@pytest.mark.parametrize("wire_dtype", ["float32", "bfloat16"])
def test_loader_batches_equal_bit_for_bit(corpus, wire_dtype):
    """Two epochs (shuffle and augmentation both keyed by the epoch),
    including the ragged tail of 22 = 5 x 4 + 2 utterances."""
    ours, ref = _loaders(corpus, wire_dtype)
    assert len(ours) == len(ref) == 6
    for _ in range(2):
        pairs = list(zip(ours, ref, strict=True))
        for a, b in pairs:
            _assert_batches_equal(a, b)
    a = pairs[-1][0]
    want = torch.bfloat16 if wire_dtype == "bfloat16" else np.float32
    assert (a.inputs.dtype == want)


def test_host_spliced_loader_matches(corpus):
    ours, ref = _loaders(corpus, None, device_frontend=False)
    for a, b in zip(ours, ref, strict=True):
        _assert_batches_equal(a, b)
    assert a.inputs.shape[-1] == 3 * FEAT_DIM


def test_set_epoch_resumes_the_sequence(corpus):
    ours, ref = _loaders(corpus, "float32")
    list(ours)
    later = list(ours)                       # epoch 2
    resumed, _ = _loaders(corpus, "float32")
    resumed.set_epoch(1)
    for a, b in zip(resumed, later, strict=True):
        _assert_batches_equal(a, b)


@pytest.mark.parametrize("wire_dtype", ["float32", "bfloat16"])
def test_pad_batch_to_repeats_the_last_row(corpus, wire_dtype):
    ours, ref = _loaders(corpus, wire_dtype)
    a, b = list(ours)[-1], list(ref)[-1]
    assert a.size == 2
    (pa, va), (pb, vb) = pad_batch_to(a, 4), jax_pad_batch_to(b, 4)
    _assert_batches_equal(pa, pb)
    np.testing.assert_array_equal(va, vb)
    assert va.tolist() == [True, True, False, False]


def test_threaded_loader_yields_the_inner_batches(corpus):
    ours, _ = _loaders(corpus, "float32")
    plain, _ = _loaders(corpus, "float32")
    threaded = ThreadedLoader(ours, prefetch=2)
    assert threaded.batch_size == 4 and len(threaded) == 6
    for a, b in zip(threaded, plain, strict=True):
        _assert_batches_equal(a, b)
