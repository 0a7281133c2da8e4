"""Vocabulary, the speech dataset, bucketed loaders and prefetch."""
