"""Mean host milliseconds the CachedLoader takes to yield a batch (its
schedule, each row's augmentation draws and label padding), timed around
`next()` by the feed."""


def read(rec):
    if not rec.stats:
        return None
    return 1e3 * sum(s.host_s for s in rec.stats) / len(rec.stats)
