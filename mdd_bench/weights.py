"""The cell's weights, drawn from the run's seed on the run's device.

One `torch.rand` over every parameter at once, from a Generator on the
device, then each leaf scaled to its initializer's spread: the recurrent
weights and biases U(-1/sqrt(H), 1/sqrt(H)) as the recipe draws them, the
convolution and dense kernels and the embedding uniform with the standard
deviation of their lecun-normal and N(0, 1/features) initializers,
BatchNorm at identity and the convolution biases at 0.  The program and
the reference both start from these weights; neither makes its own.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from mdd_bench.reference import param_shapes


def _spread(name: str, shape: tuple, hidden: int):
    """-> (half-width of the uniform draw, constant) of a leaf: a constant
    leaf has half-width 0."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.startswith(("w_ih", "w_hh", "b_fwd", "b_bwd")):
        return hidden ** -0.5, 0.0
    if leaf == "kernel":
        fan_in = math.prod(shape[1:]) if len(shape) == 4 else shape[0]
        return math.sqrt(3.0 / fan_in), 0.0
    if leaf == "embedding":
        return math.sqrt(3.0 / shape[1]), 0.0
    if leaf == "scale":
        return 0.0, 1.0
    if leaf == "bias":
        return 0.0, 0.0
    raise ValueError(f"no initializer for parameter {name}")


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(
        (seed * 0x9E3779B97F4A7C15 + 7) % 2 ** 63)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        half, const = _spread(name, shape, cfg["rnn_hidden_size"])
        out[name] = (flat[at:at + n] * half + const).view(shape)
        at += n
    return out
