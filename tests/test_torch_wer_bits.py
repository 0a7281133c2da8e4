"""The bit-parallel edit distance of csrc/wer.cu on the CPU: its plain
Python model (ops/wer_cuda.edit_distance_bits / greedy_wer_bits: the
recurrence word by word, the add's carry and the shifts crossing words as
the kernel's lanes pass them) against mdd_tpu's `batched_edit_distance`
and `greedy_wer_counts` (JAX on the CPU) and the port's plain
`ops/wer.greedy_wer_counts`, on numpy-seeded rows.  Words of 64 bits are
the kernel's (one word while L <= 64, a word a lane past it); words of 8
and 16 bits put the carry across words into every row of a short target.

Target sizes below 0: mdd_tpu's gather indexes as NumPy does, so a size
in [-L-1, -1] reads row L + 1 + size; the kernel (in both its designs)
clamps it to 0.  Those rows are held to mdd_tpu's distance at size 0, the kernel's
contract; no caller passes a negative size (they are label lengths)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdd_tpu.ops import wer as jax_wer
from mdd_tpu_torch.ops import wer_cuda
from mdd_tpu_torch.ops.wer import greedy_wer_counts

CLASSES = 43


def _rows(b, t, l, seed, case="random"):
    """ids (B, T) over 43 classes (a third blank, 30% repeats of the frame
    before), frames in [0, T], targets 1-42, sizes in [0, L], a sixth of
    the rows invalid; `case` bends one half of the rows."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CLASSES, (b, t))
    ids[rng.random((b, t)) < 1 / 3] = 0
    repeat = rng.random((b, t - 1)) < 0.3
    ids[:, 1:] = np.where(repeat, ids[:, :-1], ids[:, 1:])
    frames = rng.integers(0, t + 1, b)
    frames[0] = t
    targets = rng.integers(1, CLASSES, (b, l))
    sizes = rng.integers(0, l + 1, b)
    sizes[0] = l
    valid = rng.random(b) > 1 / 6
    half = b // 2
    if case == "sizes above L":
        sizes[:half] = l + rng.integers(1, 50, half)
    elif case == "sizes below 0":
        sizes[:half] = -rng.integers(1, l + 3, half)
    elif case == "no frames":
        frames[:half] = 0
    elif case == "no targets":
        sizes[:half] = 0
    elif case == "only blanks":
        ids[:half] = 0
    elif case == "repeated tokens":
        # runs of one token, and the same token kept after a blank
        ids[:half] = np.repeat(rng.integers(1, 4, (half, t // 3 + 1)), 3,
                               axis=1)[:, :t]
        ids[:half, 5::7] = 0
        targets[:half] = np.repeat(rng.integers(1, 4, (half, l // 2 + 1)),
                                   2, axis=1)[:, :l]
    return ids, frames, targets, sizes, valid


def _mdd_tpu(ids, frames, targets, sizes, valid):
    """mdd_tpu's distances and counts, read at the kernel's clamp of the
    sizes below 0 (see the module's note)."""
    at = np.maximum(sizes, 0)
    b, t = ids.shape
    tvalid = np.arange(t)[None] < frames[:, None]
    prev = np.concatenate([np.full((b, 1), -1), ids[:, :-1]], axis=1)
    keep = tvalid & (ids != 0) & (ids != prev)
    pred = np.zeros((b, t), np.int32)
    for r in range(b):
        kept = ids[r][keep[r]]
        pred[r, :len(kept)] = kept
    dist = np.asarray(jax_wer.batched_edit_distance(
        jnp.asarray(pred), jnp.asarray(keep.sum(1), jnp.int32),
        jnp.asarray(targets, jnp.int32), jnp.asarray(at, jnp.int32)))
    errs, tokens = jax_wer.greedy_wer_counts(
        jnp.asarray(ids, jnp.int32), jnp.asarray(frames, jnp.int32),
        jnp.asarray(targets, jnp.int32), jnp.asarray(at, jnp.int32),
        jnp.asarray(valid))
    tokens = int(np.where(valid, sizes, 0).sum())
    return dist, int(errs), tokens


def _check(ids, frames, targets, sizes, valid, bits):
    args = [torch.from_numpy(a) for a in (ids, frames, targets, sizes,
                                          valid)]
    dist, errors, tokens = wer_cuda.greedy_wer_bits(*args, bits=bits)
    want_dist, want_errors, want_tokens = _mdd_tpu(ids, frames, targets,
                                                   sizes, valid)
    assert dist.tolist() == want_dist.tolist()
    assert (errors, tokens) == (want_errors, want_tokens)
    if ((sizes >= 0) & (sizes <= targets.shape[1])).all():
        plain = greedy_wer_counts(*args)
        assert (errors, tokens) == tuple(int(v) for v in plain)


@pytest.mark.parametrize("l,bits", [(l, bits) for l in (1, 40, 63, 64, 65)
                                    for bits in (64, 16, 8)] + [(1023, 64)])
def test_bit_model_equals_mdd_tpu(l, bits):
    b, t = (4, 300) if l == 1023 else (8, 110)
    _check(*_rows(b, t, l, seed=l + bits), bits=bits)
    assert wer_cuda.words_for(l) == (1 if l <= 64 else -(-l // 64))


@pytest.mark.parametrize("case", ["sizes above L", "sizes below 0",
                                  "no frames", "no targets", "only blanks",
                                  "repeated tokens"])
@pytest.mark.parametrize("l", [40, 65])
def test_bit_model_on_edge_rows(case, l):
    _check(*_rows(8, 90, l, seed=len(case) + l, case=case), bits=64)


@pytest.mark.parametrize("pred,targets,at,want", [
    ([], [], 0, 0), ([3, 4], [], 0, 2), ([], [1, 2, 3], 3, 3),
    ([1, 2, 3], [1, 2, 3], 3, 0), ([1, 2, 3], [3, 2, 1], 3, 2),
    ([1, 2, 3], [1, 2, 3], 1, 2), ([5, 5], [5], 9, 1),
    ([1, 2, 3], [1, 2, 3], -4, 3)])
def test_bit_model_on_hand_rows(pred, targets, at, want):
    """Distances worked out by hand, `at` clamped to [0, len(targets)]; one
    word and words of one bit (a carry across words at every row)."""
    for bits in (64, 1):
        assert wer_cuda.edit_distance_bits(pred, targets, at, bits) == want
