"""One command over every local card: the ranks of mdd_tpu's one-process
mesh (counterpart of mdd_tpu/parallel/mesh.py's make_mesh and of the
single process that spreads over it).

mdd_tpu runs one process over the host's accelerators: `make_mesh(N)`
takes the first N devices, every one for N = 0, and the config's
`data_parallel` is that N (mdd_tpu/cli.py:240).  The port keeps PyTorch's
idiom, one process a card with nccl between them, and starts those
processes itself, so that `train`, `evaluate` and `benchmark` take every
card of the host from one command:

  * `local_width` reads `data_parallel` as make_mesh does, and raises its
    ValueError for more cards than the host has, before any process
    starts;
  * `launch_local` runs the command as that many ranks on this host: the
    same arguments, torchrun's variables (a free port on the loopback,
    LOCAL_RANK = the card) and `mesh.LOCAL_MESH_ENV`, by which a rank
    reads `batch_size` as the global batch (mesh.local_mesh).  It waits
    for them; the first rank that fails ends the others at once, and its
    exit code is the command's; Ctrl-C (SIGINT) reaches every rank, and
    a rank dies with the launcher (`follow_launcher`).  Rank 0's output
    is the command's output; the others print the same lines and are not
    shown, their errors are.

Each rank builds the kernels it launches (ops/build.py): ranks that build
at once each write their own temporary file and move it into place, so
they leave one whole library.
"""

from __future__ import annotations

import ctypes
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import List, Sequence

import torch

from mdd_tpu_torch.parallel import mesh

# what every rank runs, before the command's own arguments
RANK_ENTRY = (sys.executable, "-m", "mdd_tpu_torch")
STOP_GRACE_S = 10.0   # a rank asked to stop is killed after this long
POLL_S = 0.05


def local_width(data_parallel: int, device: str,
                every_card: bool = False) -> int:
    """The number of ranks for `data_parallel` on `device`, as mdd_tpu's
    make_mesh reads it: 0 every visible card, N the first N (N past the
    card count raises make_mesh's ValueError); `every_card` takes every
    visible card whatever data_parallel says (EvalSession's
    make_local_mesh).  A device with an index (`cuda:1`) is that one
    card.  On the CPU, 0 is one process and N is N ranks (the tests'
    virtual CPU devices)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return max(int(data_parallel), 1)
    if dev.index is not None:
        return 1
    cards = torch.cuda.device_count()
    n = cards if every_card or data_parallel <= 0 else int(data_parallel)
    if n > cards:
        raise ValueError(f"requested {n} devices, have {cards}")
    # no card at all: the command itself says so
    return max(n, 1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def follow_launcher() -> None:
    """In a rank that launch_local started: be killed when the launcher
    dies (Linux's PR_SET_PDEATHSIG), and exit at once where it died
    before this call, so that no rank outlives it."""
    try:
        prctl = ctypes.CDLL(None, use_errno=True).prctl
    except (OSError, AttributeError):
        return
    prctl.argtypes = [ctypes.c_int, ctypes.c_ulong]
    prctl.restype = ctypes.c_int
    prctl(1, int(signal.SIGKILL))       # PR_SET_PDEATHSIG
    if os.getppid() != int(os.environ[mesh.LOCAL_MESH_ENV]):
        os._exit(128 + int(signal.SIGKILL))


def _relay(stream, out) -> None:
    """Copy rank 0's output to this process's stdout, line by line."""
    for line in stream:
        out.write(line)
        out.flush()


def _exit_code(rc: int) -> int:
    """A rank's exit status as a shell reports it (128 + signal)."""
    return 128 - rc if rc < 0 else rc


def _stop(procs: Sequence[subprocess.Popen], sig: int) -> None:
    """Send `sig` to the ranks still running, wait STOP_GRACE_S for them,
    then kill what is left."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(sig)
    deadline = time.monotonic() + STOP_GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _wait(procs: Sequence[subprocess.Popen]) -> int:
    """Wait for every rank; -> 0, or the exit code of the first rank that
    failed, after the others were ended at once."""
    running = list(procs)
    while running:
        for p in list(running):
            rc = p.poll()
            if rc is None:
                continue
            running.remove(p)
            if rc != 0:
                _stop(running, signal.SIGTERM)
                return _exit_code(rc)
        time.sleep(POLL_S)
    return 0


def launch_local(argv: Sequence[str], n: int, device: str = "cuda") -> int:
    """Run `RANK_ENTRY + argv` (the port's CLI) as `n` ranks on this host
    and wait for them; -> the command's exit code.  Rank r runs on card r
    (`LOCAL_RANK`, mesh.init_distributed: nccl), or on the CPU (gloo),
    each with its share of the host's threads."""
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in mesh.ENV + ("LOCAL_WORLD_SIZE",)}
    if "OMP_NUM_THREADS" not in base:
        # the ranks share the host's cores (torchrun sets 1): N thread
        # pools of every core each would oversubscribe them
        base["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // n))
    print(f"data_parallel: {n} ranks on this host ({device})",
          file=sys.stderr, flush=True)
    procs: List[subprocess.Popen] = []
    relay = None
    try:
        for r in range(n):
            env = dict(base, RANK=str(r), WORLD_SIZE=str(n),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            env[mesh.LOCAL_MESH_ENV] = str(os.getpid())
            procs.append(subprocess.Popen(
                list(RANK_ENTRY) + list(argv), env=env,
                stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL,
                text=True))
            if r == 0:
                relay = threading.Thread(target=_relay,
                                         args=(procs[0].stdout, sys.stdout),
                                         daemon=True)
                relay.start()
        return _wait(procs)
    except KeyboardInterrupt:
        _stop(procs, signal.SIGINT)
        raise
    finally:
        _stop(procs, signal.SIGKILL)
        if relay is not None:
            relay.join(timeout=STOP_GRACE_S)
