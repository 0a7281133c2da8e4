"""The benchmark's few collectives over the program's process group (one
process: the identities), with torch.distributed directly."""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device() -> torch.device:
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's `obj` on every rank."""
    if world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _reduce(values: List[float], op) -> List[float]:
    if world() == 1:
        return list(values)
    t = torch.tensor(values, dtype=torch.float64, device=_device())
    dist.all_reduce(t, op=op)
    return t.cpu().tolist()


def all_sum(values: List[float]) -> List[float]:
    return _reduce(values, dist.ReduceOp.SUM)


def all_max(value: float) -> float:
    return _reduce([value], dist.ReduceOp.MAX)[0]


def all_mean(value: float) -> float:
    return all_sum([value])[0] / world()
