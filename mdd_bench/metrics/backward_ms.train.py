"""Device milliseconds a step of the kernels launched under the program's
`step.backward` spans (mdd_bench/spans.py: each kernel by its launch
event): autograd's backward of the loss and the gradients' exchange."""

from mdd_bench import spans


def read(rec):
    return spans.phase_ms(rec, "step.backward")
