"""The port's spans and counters, kept in memory on the profiler's clock.

`span(name)` marks a piece of work at a layer boundary and `count(name,
n)` adds to a counter there.  Both are off unless `enable()` holds or a
`torch.profiler` is recording: off, `span` returns one shared null
context after a module-level check and `count` returns at once, so the
train step pays one global read a boundary.  On, a span is stamped with
`time.time_ns()`, the Unix-epoch nanoseconds that kineto's events carry,
and also enters `torch.profiler.record_function(name)`, so a profiled
window (`train --profile-dir`, the benchmark's traced run) shows it with
the kernels launched under it.

Each finished span is kept as a `Span`: its `id`, its `parent` (the id
of the span that was open around it on the same thread, or None) and its
`step`, the number of `loop.step` spans finished before it opened, so a
train step's spans and the batch gathered for it share one step.
`snapshot()` hands spans and counters out as plain data; nothing here
writes a file.

The train path's names (PERF.md lists the metric that reads each):
`loop.epoch`, `loop.step`, `loop.fetch`, `step.forward`, `step.loss`,
`step.backward`, `step.optimizer` (twice a step: the gradients' reset at
its start, Adam and the metric accumulator at its end), `data.gather`,
`data.make_batch`, the counter `h2d_bytes`; set-up: `setup.trainer`,
`setup.device_cache`, `kernel.build`.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

from torch import profiler
from torch.autograd import profiler as _autograd_profiler

STEP = "loop.step"


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    step: int
    thread: int


_NULL = contextlib.nullcontext()
_enabled = False
_spans: List[Span] = []
_counters: Dict[str, int] = {}
_count_lock = threading.Lock()
_ids = itertools.count()
_steps = 0
_local = threading.local()     # `open`: the ids of this thread's open spans


def _profiling() -> bool:
    """A torch.profiler records (torch's own flag, read where it lives
    because the profiler rebinds it; False if torch drops it)."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    """Off again for spans opened from now on (a profiler that records
    keeps them on); a span that is open still closes and is kept."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Forget every span, counter and step finished so far."""
    global _steps
    with _count_lock:
        _spans.clear()
        _counters.clear()
        _steps = 0


def snapshot() -> dict:
    """{"spans": [Span as a dict, ...] in the order they finished,
    "counters": {name: total}}."""
    with _count_lock:
        return {"spans": [s._asdict() for s in _spans],
                "counters": dict(_counters)}


def count(name: str, n: int) -> None:
    if not (_enabled or _profiling()):
        return
    with _count_lock:
        _counters[name] = _counters.get(name, 0) + int(n)


class _Span:
    __slots__ = ("name", "rf", "id", "parent", "step", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "open", None)
        if stack is None:
            stack = _local.open = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.step = _steps
        stack.append(self.id)
        # the stamps enclose the record_function's, a few us apart
        self.rf = profiler.record_function(self.name)
        self.start = time.time_ns()
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        global _steps
        self.rf.__exit__(*exc)
        end = time.time_ns()
        _local.open.pop()
        with _count_lock:
            _spans.append(Span(self.name, self.start, end, self.id,
                               self.parent, self.step,
                               threading.get_ident()))
            if self.name == STEP:
                _steps += 1
        return False


def span(name: str):
    """A context manager around one piece of work named `name`."""
    if not (_enabled or _profiling()):
        return _NULL
    return _Span(name)


def open_spans() -> int:
    """Spans open on this thread."""
    return len(getattr(_local, "open", ()))
