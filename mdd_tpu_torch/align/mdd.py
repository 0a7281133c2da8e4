"""Mispronunciation-detection accounting on alignment paths (counterpart
of mdd_tpu/align/mdd.py; host only).

Reproduces, with documented parity, the scoring semantics of the reference:

* ``alignment_to_slots`` — test_ctc_nosil.print_align_space_canonical_origin
  (:33-82): expand an op path into a per-canonical-slot dict plus an
  insertion list.
* ``mdd_accumulate`` — the TA/FR/FA/TR(+-diagnosis) accounting over two
  slot dicts (test_ctc_nosil.py:240-298), including the reference's
  mutate-while-iterating semantics on the insertion lists (a faithful
  replication: removing items during iteration skips successors, which
  affects counts when duplicate insertion markers occur).
* ``align_canonical_decoded`` / ``fault_statistics`` / ``word_score`` —
  the single-word product diagnosis of infer.py (:162-209, :405-433,
  :341-342).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple


def alignment_to_slots(hyp: Sequence[str], canonical: Sequence[str], ops: Sequence[str]) -> Dict:
    """Map an op path onto canonical-phone slots.

    Args:
      hyp: hypothesis-side phones (human annotation or decoder output).
      canonical: canonical prompt phones.
      ops: ['-','S','I','D'] path from align(hyp, canonical).

    Returns a dict with one key per canonical position j holding '-',
    'S<hyp_phone>' or 'D', plus key 'I' holding the insertion markers
    (string `str(j-1)+str(j)` for an insertion between canonical slots
    j-1 and j — reference test_ctc_nosil.py:58).
    """
    d: Dict = {j: "" for j in range(len(canonical))}
    d["I"] = []
    hyp = list(hyp)
    i = 0
    j = 0
    while i < len(ops):
        if ops[i] == "-" or ops[i] == "S":
            d[j] = ops[i]
            if ops[i] == "S":
                d[j] += hyp[i]
            i += 1
            j += 1
            continue
        if ops[i] == "D":
            d[j] = "D"
            j += 1
            hyp.insert(i, "D")
        else:
            d["I"] += [str(j - 1) + str(j)]
        i += 1
    return d


@dataclass
class MddCounts:
    """Hierarchical MDD tallies (TA/FR/FA/TR with diagnosis split)."""

    true_accept: int = 0
    false_rejection: int = 0
    false_accept: int = 0
    tr_correct_diag: int = 0
    tr_wrong_diag: int = 0
    total_canonical_phones: int = 0

    @property
    def true_rejection(self) -> int:
        return self.tr_correct_diag + self.tr_wrong_diag

    @property
    def precision(self) -> float:
        tr = self.true_rejection
        return tr / (tr + self.false_rejection) if tr + self.false_rejection else 0.0

    @property
    def recall(self) -> float:
        tr = self.true_rejection
        return tr / (tr + self.false_accept) if tr + self.false_accept else 0.0

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if p + r else 0.0

    def merge(self, other: "MddCounts") -> "MddCounts":
        return MddCounts(
            self.true_accept + other.true_accept,
            self.false_rejection + other.false_rejection,
            self.false_accept + other.false_accept,
            self.tr_correct_diag + other.tr_correct_diag,
            self.tr_wrong_diag + other.tr_wrong_diag,
            self.total_canonical_phones + other.total_canonical_phones,
        )


def mdd_accumulate(d1: Dict, d2: Dict, counts: MddCounts) -> None:
    """Accumulate TA/FR/FA/TR from label-vs-canonical (d1) and
    decoded-vs-canonical (d2) slot dicts.

    Semantics pinned to test_ctc_nosil.py:240-298.  NOTE: the insertion-slot
    matching intentionally iterates d1['I'] while removing matched entries
    from both lists (reference :280-283); this skips the element following
    each match, which we reproduce for metric parity.
    """
    counts.total_canonical_phones += len(d1.keys()) - 1
    for k in d1.keys():
        if k != "I":
            if d1[k] == "-" and d2[k] == "-":
                counts.true_accept += 1
            elif d1[k] == "-" and d2[k] != "-":
                counts.false_rejection += 1
            elif d1[k] != "-" and d2[k] == "-":
                counts.false_accept += 1
            else:
                if d1[k] == d2[k]:
                    counts.tr_correct_diag += 1
                else:
                    counts.tr_wrong_diag += 1
        else:
            if d1["I"] == [] and d2["I"] == []:
                pass
            elif d1["I"] != [] and d2["I"] == []:
                counts.false_accept += len(d1["I"])
            elif d1["I"] == [] and d2["I"] != []:
                counts.false_rejection += len(d2["I"])
            else:
                for e in d1["I"]:  # mutate-while-iterating: parity with reference
                    if e in d2["I"]:
                        d1["I"].remove(e)
                        d2["I"].remove(e)
                        counts.tr_correct_diag += 1
                counts.false_accept += len(d1["I"])
                counts.false_rejection += len(d2["I"])


def mdd_accumulate_subset(d1: Dict, d2: Dict, counts: MddCounts) -> None:
    """Per-accent subset tallies (the reference's Mandarin-speaker branch,
    test_ctc_nosil.py:249-297).

    Identical to ``mdd_accumulate`` except in the two one-sided insertion
    branches, where the reference adds 1 instead of the list length
    (:273,:277) — a quirk preserved for metric parity.  Callers wanting
    both the overall and subset tallies should pass copies to one of the
    two calls: the insertion matching mutates d1['I']/d2['I'].
    """
    counts.total_canonical_phones += len(d1.keys()) - 1
    for k in d1.keys():
        if k != "I":
            if d1[k] == "-" and d2[k] == "-":
                counts.true_accept += 1
            elif d1[k] == "-" and d2[k] != "-":
                counts.false_rejection += 1
            elif d1[k] != "-" and d2[k] == "-":
                counts.false_accept += 1
            else:
                if d1[k] == d2[k]:
                    counts.tr_correct_diag += 1
                else:
                    counts.tr_wrong_diag += 1
        else:
            if d1["I"] == [] and d2["I"] == []:
                pass
            elif d1["I"] != [] and d2["I"] == []:
                counts.false_accept += 1      # reference quirk: not len()
            elif d1["I"] == [] and d2["I"] != []:
                counts.false_rejection += 1   # reference quirk: not len()
            else:
                for e in d1["I"]:
                    if e in d2["I"]:
                        d1["I"].remove(e)
                        d2["I"].remove(e)
                        counts.tr_correct_diag += 1
                counts.false_accept += len(d1["I"])
                counts.false_rejection += len(d2["I"])


def align_canonical_decoded(
    decoded: List[str], canonical: List[str], ops: List[str]
) -> Tuple[List[str], List[str], List[str]]:
    """Merge an op path into decoded/canonical streams with placeholders.

    Inserts 'D' placeholders into the decoded stream and 'I' placeholders
    into the canonical stream so that both streams and the op path have
    equal length, then applies the two leading-artifact trims of the
    reference product pipeline (infer.py:162-209): drop a run of leading
    insertions, and drop a leading insertion that duplicates the first
    decoded phone.
    """
    decoded = list(decoded)
    canonical = list(canonical)
    ops = list(ops)
    ins_positions: List[int] = []
    i = 0
    j = 0
    while i < len(ops):
        if ops[i] == "-" or ops[i] == "S":
            i += 1
            j += 1
            continue
        if ops[i] == "D":
            j += 1
            decoded.insert(i, "D")
        else:
            ins_positions.append(i)
            canonical.insert(i, "I")
        i += 1

    # Trim the leading-insertion artifact (infer.py:187-201).
    if ins_positions:
        i = 0
        while i == ins_positions[i]:
            i += 1
            if i == len(ins_positions):
                break
        if i > 0:
            decoded = decoded[i - 1:]
            canonical = canonical[i - 1:]
            ops = ops[i - 1:]

    # Trim a doubled first phone behind a leading insertion (infer.py:203-207).
    if ops and ops[0] == "I" and canonical and canonical[0] == "I" \
            and len(decoded) >= 2 and decoded[0] == decoded[1]:
        ops = ops[1:]
        canonical = canonical[1:]
        decoded = decoded[1:]

    return decoded, canonical, ops


# Confusable-phone forgiveness tiers (reference infer.py:69-100 `g_pairs`).
# Keyed by strictness level; canonical phone -> decoded phone(s) accepted
# as that canonical phone.  The reference defines these plus `mild1` but
# never calls them (README.md:5 advertises the strict criterion); they
# are ported behind an off-by-default `level` switch for capability
# parity.
G_PAIRS: Dict[int, Dict[str, List[str]]] = {
    0: {"ah": ["ae"]},
    1: {
        "ae": ["eh"], "eh": ["ae"], "ih": ["iy"], "iy": ["ih"],
        "er": ["ah", "aa"], "v": ["w"], "w": ["v"], "ay": ["ae"],
        "uw": ["ah", "uh"], "aa": ["ah", "ao"], "ah": ["ao", "ow"],
        "th": ["s"], "ng": ["n"], "dh": ["z", "d"], "aw": ["ah"],
        "ey": ["eh"], "uh": ["ow"], "ao": ["aa"], "m": ["n"], "n": ["m"],
    },
    2: {"z": ["s"]},
}


def forgiveness_pairs(level: int = 1) -> Dict[str, List[str]]:
    """Merge G_PAIRS tiers 0..level (reference mild1:102-115)."""
    pairs: Dict[str, List[str]] = {}
    for i in range(level + 1):
        for k, v in G_PAIRS.get(i, {}).items():
            pairs.setdefault(k, []).extend(v)
    return pairs


def apply_forgiveness(
    decoded: List[str], canonical: List[str], ops: List[str],
    level: int = 1,
) -> Tuple[List[str], List[str], List[str]]:
    """Forgive confusable-phone substitutions (reference mild1:102-153).

    Operates on the placeholder-expanded token streams from
    align_canonical_decoded: a substitution slot whose canonical phone c
    is in the merged pair table and whose decoded phone is in pairs[c]
    is rewritten to a correct slot ('-') with the decoded phone set to
    the canonical one.  The reference implementation works on the
    column-padded display *strings* and carries extra pop() logic that
    only compensates for width-padding artifacts of that representation;
    on token lists the rewrite is exactly this.
    """
    pairs = forgiveness_pairs(level)
    decoded, canonical, ops = list(decoded), list(canonical), list(ops)
    for i, op in enumerate(ops):
        if (op == "S" and canonical[i] in pairs
                and decoded[i] in pairs[canonical[i]]):
            ops[i] = "-"
            decoded[i] = canonical[i]
    return decoded, canonical, ops


def fault_statistics(
    ops: Sequence[str], canonical: Sequence[str], decoded: Sequence[str]
) -> Tuple[List[str], List[str], List[str]]:
    """Per-op fault lists (insertions/substitutions/deletions).

    Mirrors infer.stastics:405-433; expects the placeholder-expanded
    streams from align_canonical_decoded (all three sequences share one
    index space).
    """
    insertion, substitution, deletion = [], [], []
    for idx, op in enumerate(ops):
        if op == "S":
            substitution.append(canonical[idx])
        elif op == "I":
            insertion.append(decoded[idx])
        elif op == "D":
            deletion.append(canonical[idx])
    return insertion, substitution, deletion


def word_score(ops: Sequence[str], n_insertion_faults: int) -> Tuple[int, int, int]:
    """0-100 pronunciation score for one word (infer.py:338-342).

    Returns (score, correct_cnt, correct_cnt + del_sub_cnt).
    """
    del_sub = sum(1 for c in ops if c in ("D", "S"))
    correct = sum(1 for c in ops if c == "-")
    tmp = min(n_insertion_faults / 4, 0.1 * (correct + del_sub))
    denom = del_sub + correct
    score = math.ceil((1 - (del_sub + tmp) / denom) * 100) if denom else 0
    return score, correct, correct + del_sub
