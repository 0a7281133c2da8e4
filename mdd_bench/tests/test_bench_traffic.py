"""The traffic is the seed's: the same seed gives the same corpus, another
seed another, always with the same multiset of sizes."""

import numpy as np

from mdd_bench import corpus, manifest

SMALL = {"n_utts": 64}


def _mix():
    return dict(manifest.traffic("train_b256"), **SMALL)


def _units():
    return manifest.config("attention_aug")["units"]


def test_same_seed_same_corpus():
    a = corpus.generate(_mix(), _units(), 2 ** 31 + 77)
    b = corpus.generate(_mix(), _units(), 2 ** 31 + 77)
    assert a.actual == b.actual and a.canonical == b.canonical
    assert all(np.array_equal(x, y) for x, y in zip(a.feats, b.feats))


def test_another_seed_other_inputs_same_sizes():
    a = corpus.generate(_mix(), _units(), 5)
    b = corpus.generate(_mix(), _units(), 6)
    assert a.actual != b.actual
    assert not np.array_equal(a.feats[0], b.feats[0]) or \
        a.feats[0].shape != b.feats[0].shape
    assert sorted(a.lengths) == sorted(b.lengths)
    assert sorted(map(len, a.actual)) == sorted(map(len, b.actual))


def test_the_statistics_of_make_split():
    mix = _mix()
    c = corpus.generate(mix, _units(), 3)
    n = np.asarray([len(p) for p in c.actual])
    assert n.min() >= mix["min_phones"] + 2
    assert n.max() <= mix["max_phones"] + 1
    assert all(p[0] == "sil" and p[-1] == "sil" for p in c.actual)
    per_phone = c.lengths / n
    assert per_phone.min() >= mix["min_dur"]
    assert per_phone.max() <= mix["max_dur"] - 1
    assert all(f.shape[1] == 81 and f.dtype == np.float32 for f in c.feats)
    inner = sum(len(a) - 2 for a in c.actual)
    subst = sum(x != y for a, b in zip(c.actual, c.canonical)
                for x, y in zip(a, b))
    assert 0.05 < subst / inner < 0.3


def test_written_corpus_reads_back(tmp_path):
    from mdd_tpu_torch.frontend import kaldi_io

    c = corpus.generate(_mix(), _units(), 9)
    paths = corpus.write(c, tmp_path)
    scp = kaldi_io.read_scp(paths["train_scp_path"])
    mats = kaldi_io.bulk_load(list(scp.values()))
    assert list(scp) == c.utts
    assert all(np.array_equal(m, f) for m, f in zip(mats, c.feats))
