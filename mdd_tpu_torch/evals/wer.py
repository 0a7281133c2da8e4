"""Corpus-level WER/PER scoring with Kaldi compute-wer parity
(counterpart of mdd_tpu/evals/wer.py; host only).

Replaces the Kaldi `compute-wer --text --mode=present` binary used by the
reference scoring script (result/mdd_result.sh:6): same counting, same
report format, validated bit-for-bit against the committed
result/per artifact in mdd_tpu (tests/test_align_regression.py);
tests/test_torch_scoring.py holds this copy to mdd_tpu's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from mdd_tpu_torch.align.levenshtein import kaldi_edit_distance


@dataclass
class WerStats:
    errors: int = 0
    tokens: int = 0
    ins: int = 0
    dele: int = 0
    sub: int = 0
    sentences: int = 0
    wrong_sentences: int = 0
    absent_sentences: int = 0

    @property
    def wer(self) -> float:
        return 100.0 * self.errors / self.tokens if self.tokens else 0.0

    @property
    def ser(self) -> float:
        return 100.0 * self.wrong_sentences / self.sentences if self.sentences else 0.0


def read_trn(path: str) -> Dict[str, List[str]]:
    """Read an `uttid tok tok ...` transcript file into a dict."""
    out: Dict[str, List[str]] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            out[parts[0]] = parts[1:]
    return out


def corpus_wer(
    ref: Dict[str, Sequence[str]], hyp: Dict[str, Sequence[str]]
) -> WerStats:
    """Score hyp against ref over a corpus (compute-wer --mode=present)."""
    stats = WerStats()
    for utt, ref_toks in ref.items():
        if utt not in hyp:
            stats.absent_sentences += 1
            continue
        ins, dele, sub, total = kaldi_edit_distance(ref_toks, hyp[utt])
        stats.errors += total
        stats.tokens += len(ref_toks)
        stats.ins += ins
        stats.dele += dele
        stats.sub += sub
        stats.sentences += 1
        if total:
            stats.wrong_sentences += 1
    return stats


def format_per_report(stats: WerStats) -> str:
    """Render the Kaldi compute-wer report (reference result/per format)."""
    lines = [
        "%%WER %.2f [ %d / %d, %d ins, %d del, %d sub ]"
        % (stats.wer, stats.errors, stats.tokens, stats.ins, stats.dele, stats.sub),
        "%%SER %.2f [ %d / %d ]"
        % (stats.ser, stats.wrong_sentences, stats.sentences),
        "Scored %d sentences, %d not present in hyp."
        % (stats.sentences, stats.absent_sentences),
    ]
    return "\n".join(lines)
