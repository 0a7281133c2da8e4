"""Device milliseconds a step of the kernels launched under the program's
`step.forward` spans (mdd_bench/spans.py: each kernel by its launch
event): the model call: the device splice, the convolutions, the
acoustic and text LSTMs, the attention and the head."""

from mdd_bench import spans


def read(rec):
    return spans.phase_ms(rec, "step.forward")
