"""The port's one float32 rule, used by training and evaluation alike."""

from __future__ import annotations

import torch


def strict_float32(device, compute_dtype: str) -> None:
    """Make float32 mean float32 on a CUDA device: for `compute_dtype`
    "float32" on CUDA, turn TF32 off for cuBLAS products and cuDNN
    convolutions; anywhere else (another dtype, the CPU) do nothing.

    float32 means float32 here, as in mdd_tpu: cuDNN convolutions default
    to TF32 (about 3 decimal digits), which would move the log-probs and
    the gradients off the reference by far more than fp32 rounding.

    The flags are global to the process: once a float32 model is built on
    a card, every float32 product and convolution of the process after it
    is strict, whoever runs it.  They are set through the legacy
    `allow_tf32` flags only, never torch's newer `fp32_precision`, since
    some torch versions raise when a process mixes the two."""
    if compute_dtype == "float32" and torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def tf32_flags() -> str:
    """The two TF32 flags as one line of text."""
    return (f"cuBLAS allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
            f"cuDNN allow_tf32={torch.backends.cudnn.allow_tf32}")
