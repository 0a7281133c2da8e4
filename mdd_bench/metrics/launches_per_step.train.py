"""CUDA kernels launched on this rank's card in the traced window, per
step: a count."""


def read(rec):
    kernels = rec.kernels
    if not kernels or not rec.steps:
        return None
    return len(kernels) / rec.steps
