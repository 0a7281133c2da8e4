"""Device milliseconds a step of the kernels launched under the program's
`step.loss` spans (mdd_bench/spans.py: each kernel by its launch event):
the CTC loss, the row-count reduce, the greedy decode and its WER
counts."""

from mdd_bench import spans


def read(rec):
    return spans.phase_ms(rec, "step.loss")
