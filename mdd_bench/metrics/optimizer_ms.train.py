"""Device milliseconds a step of the kernels launched under the program's
`step.optimizer` spans (mdd_bench/spans.py: each kernel by its launch
event): the gradients' reset, Adam's update and the metric accumulator."""

from mdd_bench import spans


def read(rec):
    return spans.phase_ms(rec, "step.optimizer")
