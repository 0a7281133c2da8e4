"""Batched forward + decoding."""

from mdd_tpu_torch.evals.wer import corpus_wer, WerStats, format_per_report, read_trn
from mdd_tpu_torch.evals.analysis import hierarchical_mdd_analysis, HierarchicalMdd
