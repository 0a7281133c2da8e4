"""Hierarchical MDD analysis over three pairwise alignments
(counterpart of mdd_tpu/evals/analysis.py; host only).

Replaces the reference's Kaldi align-text + wer_per_utt_details.pl +
ins_del_sub_cor_analysis.py pipeline (result/mdd_result.sh:8-12,
result/utils/scoring/ins_del_sub_cor_analysis.py:118-219) with a single
in-process pass.  Inputs are per-utterance token sequences:

  ref       canonical prompt phones
  human     human-annotated actual phones
  ours      decoder hypothesis phones

and the analysis classifies every canonical/human slot of the
ref<->human alignment by what the recognizer did with it in the
human<->ours and ref<->ours alignments, yielding the cor_cor/sub_sub/...
hierarchy and the derived Recall/Precision/F1, TA/FR/FA,
Correct/Error-Diagnosis, FAR/FRR/DER metrics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from mdd_tpu_torch.align.levenshtein import kaldi_alignment, alignment_ops

EPS = "<eps>"


@dataclass
class HierarchicalMdd:
    # ref<->human op totals (pronunciation-error statistics)
    insert: int = 0
    delete: int = 0
    sub: int = 0
    cor: int = 0
    # hierarchy: how the system treated each human-verified slot
    cor_cor: int = 0
    cor_nocor: int = 0
    sub_sub: int = 0       # sub detected, correctly diagnosed
    sub_sub1: int = 0      # sub detected, wrongly diagnosed
    sub_nosub: int = 0     # sub missed (system output the canonical phone)
    ins_ins: int = 0
    ins_ins1: int = 0
    ins_noins: int = 0
    del_del: int = 0
    del_del1: int = 0
    del_nodel: int = 0

    @property
    def tp(self) -> int:
        return (self.sub_sub + self.ins_ins + self.del_del
                + self.sub_sub1 + self.ins_ins1 + self.del_del1)

    @property
    def fp(self) -> int:
        return self.cor_nocor

    @property
    def fn(self) -> int:
        return self.sub_nosub + self.ins_noins + self.del_nodel

    @property
    def recall(self) -> float:
        return self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0

    @property
    def precision(self) -> float:
        return self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if p + r else 0.0

    @property
    def correct_diag(self) -> int:
        return self.sub_sub + self.ins_ins + self.del_del

    @property
    def error_diag(self) -> int:
        return self.sub_sub1 + self.ins_ins1 + self.del_del1

    @property
    def ta(self) -> float:
        d = self.cor_cor + self.cor_nocor
        return self.cor_cor / d if d else 0.0

    @property
    def frr(self) -> float:
        d = self.cor_cor + self.cor_nocor
        return self.cor_nocor / d if d else 0.0

    @property
    def far(self) -> float:
        return 1.0 - self.recall

    @property
    def der(self) -> float:
        d = self.correct_diag + self.error_diag
        return self.error_diag / d if d else 0.0

    def report(self) -> str:
        lines = [
            f"insert: {self.insert}",
            f"delete: {self.delete}",
            f"sub: {self.sub}",
            f"cor: {self.cor}",
            f"sum {self.delete + self.sub + self.cor}",
            "Recall: %.4f" % self.recall,
            "Precision: %.4f" % self.precision,
            "f1:%.4f" % self.f1,
            "TA: %.4f %d" % (self.ta, self.cor_cor),
            "FR: %.4f %d" % (self.frr, self.cor_nocor),
            "FA: %.4f %d" % (
                self.fn / max(1, self.tp + self.fn), self.fn),
            "Correct Diag: %.4f %d" % (
                self.correct_diag / max(1, self.correct_diag + self.error_diag),
                self.correct_diag),
            "Error Diag: %.4f %d" % (self.der, self.error_diag),
            "FAR: %.4f" % self.far,
            "FRR: %.4f" % self.frr,
            "DER: %.4f" % self.der,
        ]
        return "\n".join(lines)


def write_per_utt_details(
    ref: Dict[str, Sequence[str]],
    hyp: Dict[str, Sequence[str]],
    path: str,
) -> None:
    """Emit Kaldi align-text | wer_per_utt_details.pl output.

    Four aligned rows per utterance (utils/scoring/
    wer_per_utt_details.pl:126-129, format example :171-174):

      UTT ref  a    <eps> b  ...
      UTT hyp  a    a     c  ...
      UTT op   C    I     S  ...
      UTT #csid <C> <S> <I> <D>
    """
    with open(path, "w", encoding="utf-8") as f:
        for utt in ref:
            if utt not in hyp:
                continue
            pairs = kaldi_alignment(ref[utt], hyp[utt])
            ops = alignment_ops(pairs)
            widths = [max(len(str(a)), len(str(b)), 1) for a, b in pairs]
            ref_row = "  ".join(str(a).ljust(w)
                                for (a, _), w in zip(pairs, widths))
            hyp_row = "  ".join(str(b).ljust(w)
                                for (_, b), w in zip(pairs, widths))
            op_row = "  ".join(o.center(w) for o, w in zip(ops, widths))
            c = ops.count("C")
            s = ops.count("S")
            i = ops.count("I")
            d = ops.count("D")
            f.write(f"{utt} ref  {ref_row}\n")
            f.write(f"{utt} hyp  {hyp_row}\n")
            f.write(f"{utt} op   {op_row}\n")
            f.write(f"{utt} #csid {c} {s} {i} {d}\n")


def wer_ops_details(
    ref: Dict[str, Sequence[str]],
    hyp: Dict[str, Sequence[str]],
    max_size: int = 16,
) -> tuple[Dict[tuple, int], str]:
    """Aggregate per-token C/S/I/D confusion counts + formatted report.

    Port of utils/scoring/wer_ops_details.pl (reference
    result/utils/scoring/wer_ops_details.pl:66-147): every aligned
    (ref_token, hyp_token) pair across the corpus is tallied, then
    emitted sorted by ref token / hyp token with the Perl script's exact
    column layout — 14-char op label, right-justified tokens padded to
    the corpus-wide max token length (capped at `max_size`), 4-space
    separators, right-justified count.

    Returns (counts keyed by (ref_token, hyp_token), formatted report).
    """
    counts: Dict[tuple, int] = {}
    for utt in ref:
        if utt not in hyp:
            continue
        for r, h in kaldi_alignment(ref[utt], hyp[utt]):
            counts[(str(r), str(h))] = counts.get((str(r), str(h)), 0) + 1

    word_len = max((max(len(r), len(h)) for r, h in counts), default=1)
    ops_len = max((len(str(c)) for c in counts.values()), default=1)
    if word_len > max_size:
        word_len = max_size

    lines = []
    for (r, h) in sorted(counts):
        c = counts[(r, h)]
        if r == h:
            label = "correct       "
        elif r == EPS:
            label = "insertion     "
        elif h == EPS:
            label = "deletion      "
        else:
            label = "substitution  "
        lines.append("%s%*s    %*s    %*d"
                     % (label, word_len, r, word_len, h, ops_len, c))
    return counts, "\n".join(lines) + ("\n" if lines else "")


def mdd_result(
    ref: Dict[str, Sequence[str]],
    human: Dict[str, Sequence[str]],
    hyp: Dict[str, Sequence[str]],
    out_dir: Optional[str] = None,
    log=print,
) -> "HierarchicalMdd":
    """The full mdd_result.sh pipeline in-process (result/mdd_result.sh:
    6-13): compute-wer PER report + three-way hierarchical analysis,
    with optional Kaldi-format detail-file emission."""
    from mdd_tpu_torch.evals.wer import corpus_wer, format_per_report

    log(format_per_report(corpus_wer(human, hyp)))
    if out_dir is not None:
        import os

        os.makedirs(out_dir, exist_ok=True)
        write_per_utt_details(ref, human,
                              os.path.join(out_dir, "ref_human_detail"))
        write_per_utt_details(human, hyp,
                              os.path.join(out_dir, "human_our_detail"))
        write_per_utt_details(ref, hyp,
                              os.path.join(out_dir, "ref_our_detail"))
        # aggregate confusion reports (wer_ops_details.pl equivalents)
        for pair, name in (((ref, human), "ref_human_ops"),
                           ((human, hyp), "human_our_ops"),
                           ((ref, hyp), "ref_our_ops")):
            _, text = wer_ops_details(*pair)
            with open(os.path.join(out_dir, name), "w",
                      encoding="utf-8") as f:
                f.write(text)
    m = hierarchical_mdd_analysis(ref, human, hyp)
    log(m.report())
    return m


def hierarchical_mdd_analysis(
    ref: Dict[str, Sequence[str]],
    human: Dict[str, Sequence[str]],
    ours: Dict[str, Sequence[str]],
) -> HierarchicalMdd:
    """Run the three-way alignment analysis over a corpus."""
    m = HierarchicalMdd()
    for utt in ref:
        if utt not in human or utt not in ours:
            continue
        rh = kaldi_alignment(ref[utt], human[utt])
        ho = kaldi_alignment(human[utt], ours[utt])
        ro = kaldi_alignment(ref[utt], ours[utt])

        rh_ref = [p[0] for p in rh]
        rh_hum = [p[1] for p in rh]
        rh_op = alignment_ops(rh)
        ho_hum = [p[0] for p in ho]
        ho_our = [p[1] for p in ho]
        ho_op = alignment_ops(ho)
        ro_ref = [p[0] for p in ro]
        ro_op = alignment_ops(ro)

        for op in rh_op:
            if op == "I":
                m.insert += 1
            elif op == "D":
                m.delete += 1
            elif op == "S":
                m.sub += 1
            else:
                m.cor += 1

        # Deletion detection: walk canonical tokens of ref<->human against
        # canonical tokens of ref<->ours (analysis script :134-154).
        flag = 0
        for i in range(len(rh_ref)):
            if rh_ref[i] == EPS:
                continue
            while ro_ref[flag] == EPS:
                flag += 1
            if rh_ref[i] == ro_ref[flag]:
                if rh_op[i] == "D" and ro_op[flag] == "D":
                    m.del_del += 1
                elif rh_op[i] == "D" and ro_op[flag] not in ("D", "C"):
                    m.del_del1 += 1
                elif rh_op[i] == "D" and ro_op[flag] == "C":
                    m.del_nodel += 1
                flag += 1

        # Correct / substitution / insertion detection: walk human tokens of
        # ref<->human against human tokens of human<->ours (:157-191).
        # NOTE the reference's 'I' here is an insertion in the *human* stream
        # relative to canonical, i.e. a phone the learner added.
        flag = 0
        for i in range(len(rh_hum)):
            if rh_hum[i] == EPS:
                continue
            while ho_hum[flag] == EPS:
                flag += 1
            if rh_hum[i] == ho_hum[flag]:
                if rh_op[i] == "C" and ho_op[flag] == "C":
                    m.cor_cor += 1
                elif rh_op[i] == "C" and ho_op[flag] != "C":
                    m.cor_nocor += 1

                if rh_op[i] == "S" and ho_op[flag] == "C":
                    m.sub_sub += 1
                elif rh_op[i] == "S" and ho_op[flag] != "C" and rh_ref[i] != ho_our[flag]:
                    m.sub_sub1 += 1
                elif rh_op[i] == "S" and ho_op[flag] != "C" and rh_ref[i] == ho_our[flag]:
                    m.sub_nosub += 1

                if rh_op[i] == "I" and ho_op[flag] == "C":
                    m.ins_ins += 1
                elif rh_op[i] == "I" and ho_op[flag] not in ("C", "D"):
                    m.ins_ins1 += 1
                elif rh_op[i] == "I" and ho_op[flag] == "D":
                    m.ins_noins += 1
                flag += 1
    return m
