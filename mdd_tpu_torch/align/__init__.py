"""Alignment and per-word MDD scoring."""

from mdd_tpu_torch.align.levenshtein import (
    edit_distance,
    backtrace_ops,
    align,
    kaldi_edit_distance,
    kaldi_alignment,
)
from mdd_tpu_torch.align.mdd import (
    alignment_to_slots,
    mdd_accumulate,
    MddCounts,
    align_canonical_decoded,
    fault_statistics,
    word_score,
)
