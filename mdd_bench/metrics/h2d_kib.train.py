"""KiB the program puts from the host on the device a train step: its
`h2d_bytes` counter (the host arrays' bytes in `Trainer.cached_arrays`
and `DeviceFeatureCache.gather`) over its `loop.step` spans."""

from mdd_bench import spans


def read(rec):
    return spans.h2d_kib(rec)
