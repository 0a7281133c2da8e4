"""The port's multi-process streaming loader against mdd_tpu's, in one
process (each rank's loader built with its process_index): the global
batch schedule (`global_schedule`, the default with several processes)
and the per-rank shards (`global_schedule=False`) give the same batches
row for row, score_mask included, for process_count 1-3; the ranks agree
on shapes and batch counts and together score every utterance once, and
their slices put together are the one-process global schedule
(tests/test_global_schedule.py holds mdd_tpu to the same)."""

import numpy as np
import pytest

from mdd_tpu.data.dataset import BucketedLoader as JaxLoader
from mdd_tpu.data.dataset import SpeechDataset as JaxDataset
from mdd_tpu.data.dataset import pad_batch_to as jax_pad_batch_to
from mdd_tpu.data.vocab import Vocab as JaxVocab
from mdd_tpu_torch.data.dataset import BucketedLoader, SpeechDataset
from mdd_tpu_torch.data.dataset import pad_batch_to
from mdd_tpu_torch.data.vocab import Vocab
from test_torch_data import UNITS, _assert_batches_equal, write_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    # 23 utterances: no process count of 2 or 3 divides it
    return write_corpus(tmp_path_factory.mktemp("global"), "train", 23,
                        seed=5, frames=(3, 9))


def _pair(corpus, device_frontend=True, wire_dtype=None, batch_size=4,
          **kw):
    ds = dict(train=True, augment_mode=2, mutation_prob=0.3,
              device_frontend=device_frontend)
    common = dict(shuffle=True, seed=3, time_quantum=8, label_quantum=4,
                  wire_dtype=wire_dtype, **kw)
    return (BucketedLoader(SpeechDataset(Vocab(UNITS), *corpus, **ds),
                           batch_size, **common),
            JaxLoader(JaxDataset(JaxVocab(UNITS), *corpus, **ds), batch_size,
                      **common))


def _equal(ours, ref):
    _assert_batches_equal(ours, ref)
    np.testing.assert_array_equal(ours.score_mask, ref.score_mask)


@pytest.mark.parametrize("device_frontend,wire_dtype", [
    (True, None), (True, "bfloat16"), (False, None)])
@pytest.mark.parametrize("process_count", [1, 2, 3])
def test_global_schedule_equals_mdd_tpu(corpus, process_count,
                                        device_frontend, wire_dtype):
    """Two shuffled, augmented epochs of every rank (raw features on a
    float32 or bfloat16 wire, or host-spliced ones)."""
    for rank in range(process_count):
        ours, ref = _pair(corpus, device_frontend, wire_dtype,
                          process_index=rank, process_count=process_count,
                          global_schedule=True)
        assert ours.global_schedule and ref.global_schedule
        assert ours.shape_coordinated
        assert len(ours) == len(ref) == -(-23 // (4 * process_count))
        for _ in range(2):
            for a, b in zip(ours, ref, strict=True):
                _equal(a, b)
                assert a.size == 4


@pytest.mark.parametrize("process_count", [2, 3])
def test_per_rank_shards_equal_mdd_tpu(corpus, process_count):
    """global_schedule=False: each rank's shard_for_host_primary share,
    the wrap-around duplicates' score_mask False, as mdd_tpu's."""
    seen = []
    for rank in range(process_count):
        ours, ref = _pair(corpus, process_index=rank,
                          process_count=process_count,
                          global_schedule=False)
        assert not ours.shape_coordinated
        for a, b in zip(ours, ref, strict=True):
            _equal(a, b)
            seen += [u for u, s in zip(a.utt_ids, a.score_mask) if s]
    assert sorted(seen) == sorted(f"train_{i:04d}" for i in range(23))


@pytest.mark.parametrize("process_count", [2, 3])
def test_ranks_agree_and_put_together_are_one_process(corpus,
                                                      process_count):
    single, _ = _pair(corpus, batch_size=4 * process_count,
                      global_schedule=True)
    ranks = [list(_pair(corpus, process_index=r,
                        process_count=process_count)[0])
             for r in range(process_count)]
    whole = list(single)
    assert all(len(r) == len(whole) for r in ranks)
    for one, *parts in zip(whole, *ranks):
        assert len({p.inputs.shape for p in parts}) == 1
        assert len({p.trans.shape for p in parts}) == 1
        np.testing.assert_array_equal(
            one.inputs, np.concatenate([p.inputs for p in parts]))
        np.testing.assert_array_equal(
            one.score_mask, np.concatenate([p.score_mask for p in parts]))
        assert one.utt_ids == sum((p.utt_ids for p in parts), [])
    scored = [u for r in ranks for b in r
              for u, s in zip(b.utt_ids, b.score_mask) if s]
    assert sorted(scored) == sorted(f"train_{i:04d}" for i in range(23))


def test_one_process_default_is_unchanged(corpus):
    """Without several processes or the flag, the per-rank path with every
    row scored: the loader of one process, as before."""
    ours, ref = _pair(corpus)
    assert not ours.global_schedule and ours.shape_coordinated
    for a, b in zip(ours, ref, strict=True):
        _equal(a, b)
        assert a.score_mask.all()


def test_pad_batch_to_carries_the_score_mask(corpus):
    ours, ref = _pair(corpus, process_index=1, process_count=2)
    a, b = list(ours)[-1], list(ref)[-1]
    (pa, va), (pb, vb) = pad_batch_to(a, 7), jax_pad_batch_to(b, 7)
    _equal(pa, pb)
    np.testing.assert_array_equal(va, vb)
    assert not pa.score_mask[4:].any()


def test_refuses_a_rank_outside_the_group(corpus):
    with pytest.raises(ValueError, match="process_index 2"):
        _pair(corpus, process_index=2, process_count=2)
