"""Device milliseconds a step of the kernels launched under the program's
`data.gather` spans (mdd_bench/spans.py: each kernel by its launch
event): the batch's arrays put on the device, its rows gathered from the
device-resident corpus and SpecAugment's masks."""

from mdd_bench import spans


def read(rec):
    return spans.phase_ms(rec, "data.gather")
