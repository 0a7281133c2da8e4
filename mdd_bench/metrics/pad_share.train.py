"""Padded frames over bucket frames of the window's batches, in %: the
share of the gathered raw frames that no real utterance fills (bucket
padding and the slots of a short batch), counted from the CachedBatch
fields the feed passed on."""


def read(rec):
    total = sum(s.rows * s.bucket for s in rec.stats)
    if not total:
        return None
    return 100.0 * (1.0 - sum(s.real_frames for s in rec.stats) / total)
