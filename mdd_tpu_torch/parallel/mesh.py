"""Process group and collectives of data-parallel runs (counterpart of
mdd_tpu/parallel/mesh.py).

mdd_tpu shards the global batch over a ('data',) device mesh and lets XLA
insert the reductions.  The port runs one process a rank, each with its
own slice of every global batch, and reduces explicitly: the masked
BatchNorm sums (`all_reduce_sum`, differentiable), the loss's row count,
the parameter gradients (`all_reduce_tensors`), the metric accumulator
and the evaluation tallies (`all_reduce_metrics`).  A rank's process is
started by torchrun or by anything that sets its variables (`ENV`);
`init_distributed` joins the group.

Two kinds of group.  Under torchrun (`--distributed`) each rank is one of
mdd_tpu's processes: `batch_size` counts its own rows and each rank
writes its own evaluation dumps.  The ranks that `parallel/launch.py`
starts on one host (`LOCAL_MESH_ENV` set) are mdd_tpu's one process over
its local mesh instead (`local_mesh`): `batch_size` counts the rows of
the global batch, which the ranks share, and rank 0
writes what one process writes.

Backend: nccl when every local rank has a card of its own; gloo when
ranks share a card (gloo moves CUDA tensors through the host) or run on
the CPU.  Gloo offers only all_reduce, broadcast and barrier on CUDA
tensors, so those three are all this module uses, apart from
reduce_scatter_tensor under nccl (`reduce_scatter_rows`).  Without a
process group every helper is the one-process identity.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
INIT_TIMEOUT_S = 300    # a rank that never arrives fails the others' init
# set by launch.launch_local, in every rank it starts, to its own pid
LOCAL_MESH_ENV = "MDD_LOCAL_MESH"


def init_distributed(device: str = "cuda",
                     timeout_s: float = INIT_TIMEOUT_S) -> torch.device:
    """Join the process group that torchrun's environment describes; ->
    this rank's device: `cuda:<LOCAL_RANK>` when the host has a card for
    every local rank (backend nccl), cuda:<LOCAL_RANK mod cards> when
    ranks share cards (gloo), the CPU for `device="cpu"` (gloo).

    Raises SystemExit naming the variables of `ENV` that are missing, and
    when `device` asks for a card the host does not have."""
    missing = [v for v in ENV if not os.environ.get(v)]
    if missing:
        raise SystemExit(
            "--distributed needs torchrun's environment: %s %s missing "
            "(launch with `torchrun --nproc-per-node N -m mdd_tpu_torch "
            "...`, or set RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and "
            "MASTER_PORT)" % (", ".join(missing),
                              "is" if len(missing) == 1 else "are"))
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise SystemExit(f"--device {device}: this host has no CUDA "
                             "device (pass --device cpu to run on the CPU)")
        dev = torch.device("cuda", local_rank % cards)
        backend = "nccl" if local_world <= cards else "gloo"
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method="env://", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def shutdown(clean: bool = True) -> None:
    """Leave the process group, if there is one: after the other ranks
    (`clean`), or at once, as a failing rank does, so that the others'
    next collective fails instead of waiting out the timeout."""
    if dist.is_initialized():
        if clean:
            dist.barrier()
        dist.destroy_process_group()


@contextlib.contextmanager
def joined(device: str):
    """init_distributed(device) for the block, left by `shutdown`, clean
    only when the block ends without an exception; -> the device."""
    dev = init_distributed(device)
    try:
        yield dev
    except BaseException:
        shutdown(clean=False)
        raise
    shutdown()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> str:
    return dist.get_backend() if dist.is_initialized() else "none"


def launched_locally() -> bool:
    """Whether launch.launch_local started this process as a rank."""
    return bool(os.environ.get(LOCAL_MESH_ENV))


def local_mesh() -> bool:
    """Whether the process group is mdd_tpu's one process over its local
    mesh (the ranks of launch.launch_local): `batch_size` then counts the
    global batch's rows, and rank 0 writes one process's files."""
    return process_count() > 1 and launched_locally()


def _collective_device() -> torch.device:
    """Where a host-side value goes for a collective: nccl reduces only
    CUDA tensors, gloo takes CPU ones."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks whose gradient is the sum over ranks of the
    gradients (each rank's loss reads the global sum)."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over ranks, differentiable (SyncBatchNorm's rule);
    `x` itself in one process."""
    if process_count() == 1:
        return x
    return _AllReduceSum.apply(x)


def barrier() -> None:
    """Wait for every rank; nothing in one process."""
    if process_count() > 1:
        dist.barrier()


def all_reduce_tensors(tensors: Sequence[torch.Tensor]) -> None:
    """Sum same-shaped tensor lists over ranks in place, in one collective
    over a flat buffer (all tensors on one device and of one dtype)."""
    if process_count() == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Make every parameter and buffer of `module` rank `src`'s."""
    if process_count() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)


def all_reduce_metrics(values) -> np.ndarray:
    """Sum a numeric host vector over ranks (the evaluation tallies, the
    metric accumulator); a copy of it in one process."""
    arr = np.asarray(values)
    if process_count() == 1:
        return arr.copy()
    t = torch.as_tensor(arr).to(_collective_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def all_gather_bytes(data: bytes) -> list:
    """Every rank's `data`, in rank order, on every rank: their lengths,
    then the bytes, each rank's at its own offset and zeros elsewhere,
    summed over the ranks (all_reduce only, as everywhere here)."""
    n = process_count()
    if n == 1:
        return [bytes(data)]
    lengths = np.zeros(n, np.int64)
    lengths[process_index()] = len(data)
    lengths = all_reduce_metrics(lengths)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    buf = np.zeros(int(offsets[-1]), np.uint8)
    lo = int(offsets[process_index()])
    buf[lo:lo + len(data)] = np.frombuffer(data, np.uint8)
    t = torch.from_numpy(buf).to(_collective_device())
    dist.all_reduce(t)
    out = t.cpu().numpy().tobytes()
    return [out[int(offsets[r]):int(offsets[r + 1])] for r in range(n)]


def reduce_scatter_rows(x: torch.Tensor) -> torch.Tensor:
    """Sum (N * r, ...) over the N ranks and return this rank's r rows:
    reduce_scatter_tensor under nccl, all_reduce and a slice under gloo."""
    n = process_count()
    if n == 1:
        return x
    rows = x.shape[0] // n
    if backend() == "nccl":
        out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x.contiguous())
        return out
    x = x.contiguous().clone()
    dist.all_reduce(x)
    r = process_index()
    return x[r * rows:(r + 1) * rows]


def describe(device: torch.device) -> str:
    """The line every rank prints once it joined."""
    return (f"distributed: process {process_index()}/{process_count()}, "
            f"backend {backend()}, device {device}")

