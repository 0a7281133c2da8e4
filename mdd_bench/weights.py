"""The cell's weights, drawn from the run's seed on the run's device.

One `torch.rand` over every parameter at once, from a Generator on the
device, then each leaf scaled to its initializer's spread, which the
configuration's family gives (`families/<family>.py`: `param_shapes` and
`spread`).  The program and the reference both start from these weights;
neither makes its own.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from mdd_bench import manifest


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    family = manifest.family(cfg)
    shapes = family.param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(
        (seed * 0x9E3779B97F4A7C15 + 7) % 2 ** 63)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        half, const = family.spread(name, shape, cfg)
        out[name] = (flat[at:at + n] * half + const).view(shape)
        at += n
    return out
