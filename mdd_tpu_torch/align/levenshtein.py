"""Edit-distance alignment with reference-exact backtrace semantics
(counterpart of mdd_tpu/align/levenshtein.py).

Two families live here:

1. ``edit_distance`` / ``backtrace_ops`` / ``align`` reproduce the in-repo
   Python scorer of the reference (egs/attention_aug/utils/ctcDecoder.py:
   118-184): uniform costs, and a backtrace whose tie order is
   match > substitution > insertion > deletion, where *insertion* consumes a
   token of the first (hypothesis) sequence and *deletion* consumes a token
   of the second (canonical/reference) sequence.  The MDD accounting of
   test_ctc_nosil.py is pinned to this exact tie order.

2. ``kaldi_edit_distance`` / ``kaldi_alignment`` reproduce the Kaldi
   `compute-wer` / `align-text` binaries used by result/mdd_result.sh:6-12
   (its `%WER ... [ errors / tokens, ins, del, sub ]` line).

The DPs run on host NumPy: sequences are short (at most a few hundred
phones) and this code sits outside the device path.
"""

from __future__ import annotations

from typing import Hashable, List, Sequence, Tuple

import numpy as np


def edit_distance(src: Sequence, tgt: Sequence) -> Tuple[int, np.ndarray]:
    """Uniform-cost Levenshtein distance plus the full DP matrix.

    Mirrors ctcDecoder._edit_distance:134-152 (vectorized over rows).
    Returns (distance, dp) where dp has shape (len(src)+1, len(tgt)+1).
    """
    L1, L2 = len(src), len(tgt)
    dp = np.zeros((L1 + 1, L2 + 1), dtype=np.int32)
    dp[0, :] = np.arange(L2 + 1)
    dp[:, 0] = np.arange(L1 + 1)
    if L1 and L2:
        # Intern tokens to ints so the row update vectorizes (cf. the
        # reference's word2int trick in ctcDecoder.wer:118-123).
        tok2int = {t: i for i, t in enumerate(dict.fromkeys(list(src) + list(tgt)))}
        src_ids = [tok2int[s] for s in src]
        tgt_arr = np.asarray([tok2int[t] for t in tgt], dtype=np.int64)
        idx = np.arange(L2 + 1, dtype=np.int32)
        for i in range(1, L1 + 1):
            cost = (src_ids[i - 1] != tgt_arr).astype(np.int32)
            row = dp[i]
            prev = dp[i - 1]
            row[1:] = prev[:-1] + cost
            np.minimum(row[1:], prev[1:] + 1, out=row[1:])
            # left-to-right prefix pass for insertions into the tgt
            # dimension: row[j] = min_{k<=j}(row[k] + (j - k)), i.e. a
            # running minimum of (row - idx) shifted back by idx — exact
            # integer equivalence with the sequential relaxation
            np.minimum(row, np.minimum.accumulate(row - idx) + idx,
                       out=row)
    return int(dp[L1, L2]), dp


def backtrace_ops(src: Sequence, tgt: Sequence, dp: np.ndarray) -> List[str]:
    """Backtrace the DP into ['-','S','I','D'] ops, reference tie order.

    Mirrors ctcDecoder.printChanges:154-184: at each cell prefer match,
    then substitution, then 'I' (consume src token: an extra hypothesis
    phone), then 'D' (consume tgt token: a missing canonical phone).
    """
    ops: List[str] = []
    i, j = len(src), len(tgt)
    while i > 0 or j > 0:
        if i == 0:
            ops.append("D")
            j -= 1
        elif j == 0:
            ops.append("I")
            i -= 1
        elif src[i - 1] == tgt[j - 1]:
            i -= 1
            j -= 1
            ops.append("-")
        elif dp[i, j] == dp[i - 1, j - 1] + 1:
            i -= 1
            j -= 1
            ops.append("S")
        elif dp[i, j] == dp[i - 1, j] + 1:
            i -= 1
            ops.append("I")
        else:
            j -= 1
            ops.append("D")
    return ops[::-1]


def align(hyp: Sequence, ref: Sequence) -> Tuple[int, List[str]]:
    """Distance + op path between hypothesis and reference sequences.

    Equivalent to ctcDecoder.wer(s1=hyp_string, s2=ref_string):118-127 but
    operating directly on token sequences.
    """
    dist, dp = edit_distance(hyp, ref)
    return dist, backtrace_ops(hyp, ref, dp)


# ---------------------------------------------------------------------------
# Kaldi-compatible scoring (compute-wer / align-text parity)
# ---------------------------------------------------------------------------

def kaldi_edit_distance(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int, int]:
    """(ins, del, sub, total) edit errors, Kaldi compute-wer semantics.

    Reimplements the row-DP of Kaldi util/edit-distance-inl.h.  The
    effective tie preference is insertion over deletion over
    substitution (candidates evaluated sub -> del -> ins, later ones
    replacing on <=).  This exact order reproduces the committed
    result/per artifact `597 ins, 852 del, 2974 sub` bit-for-bit
    (pinned for mdd_tpu by tests/test_align_regression.py;
    tests/test_torch_scoring.py holds this copy to mdd_tpu's).
    """
    # state per cell: (total, ins, del, sub)
    prev = [(j, j, 0, 0) for j in range(len(hyp) + 1)]
    for i in range(1, len(ref) + 1):
        cur = [(prev[0][0] + 1, prev[0][1], prev[0][2] + 1, prev[0][3])]
        r = ref[i - 1]
        for j in range(1, len(hyp) + 1):
            sub_cost = 0 if r == hyp[j - 1] else 1
            d = prev[j - 1]
            best = (d[0] + sub_cost, d[1], d[2], d[3] + sub_cost)
            dele = prev[j]
            cand = (dele[0] + 1, dele[1], dele[2] + 1, dele[3])
            if cand[0] <= best[0]:
                best = cand
            ins = cur[j - 1]
            cand = (ins[0] + 1, ins[1] + 1, ins[2], ins[3])
            if cand[0] <= best[0]:
                best = cand
            cur.append(best)
        prev = cur
    total, ins, dele, sub = prev[-1]
    return ins, dele, sub, total


def kaldi_alignment(
    ref: Sequence[Hashable],
    hyp: Sequence[Hashable],
    eps: str = "<eps>",
) -> List[Tuple[Hashable, Hashable]]:
    """Pairwise alignment a la Kaldi align-text (LevenshteinAlignment).

    Returns [(ref_tok|eps, hyp_tok|eps), ...].  Kaldi's backtrace walks
    from the end preferring, on ties, deletion, then insertion, then
    sub/correct (this matches its DP update order where the last winning
    candidate on <= comparisons is kept).
    """
    L1, L2 = len(ref), len(hyp)
    dp = np.zeros((L1 + 1, L2 + 1), dtype=np.int32)
    dp[0, :] = np.arange(L2 + 1)
    dp[:, 0] = np.arange(L1 + 1)
    idx = np.arange(L2 + 1, dtype=np.int32)
    for i in range(1, L1 + 1):
        cost = np.fromiter(
            (0 if ref[i - 1] == h else 1 for h in hyp), dtype=np.int32, count=L2
        )
        row = dp[i]
        prev = dp[i - 1]
        row[1:] = prev[:-1] + cost
        np.minimum(row[1:], prev[1:] + 1, out=row[1:])
        # exact prefix-min relaxation (see edit_distance)
        np.minimum(row, np.minimum.accumulate(row - idx) + idx, out=row)

    out: List[Tuple[Hashable, Hashable]] = []
    i, j = L1, L2
    while i > 0 or j > 0:
        if i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            out.append((ref[i - 1], eps))  # deletion (ref token unmatched)
            i -= 1
        elif j > 0 and dp[i, j] == dp[i, j - 1] + 1:
            out.append((eps, hyp[j - 1]))  # insertion (hyp token unmatched)
            j -= 1
        else:
            out.append((ref[i - 1], hyp[j - 1]))
            i -= 1
            j -= 1
    return out[::-1]


def alignment_ops(pairs: List[Tuple[Hashable, Hashable]], eps: str = "<eps>") -> List[str]:
    """Per-pair C/S/I/D ops for a kaldi_alignment output
    (wer_per_utt_details.pl `op` row semantics)."""
    ops = []
    for r, h in pairs:
        if r == eps:
            ops.append("I")
        elif h == eps:
            ops.append("D")
        elif r == h:
            ops.append("C")
        else:
            ops.append("S")
    return ops
