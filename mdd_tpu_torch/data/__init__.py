"""Vocabulary, the speech dataset, bucketed loaders and prefetch."""

from mdd_tpu_torch.data.vocab import Vocab
