"""The program's own spans and counters (mdd_tpu_torch/utils/trace.py) in
a traced run, for the per-layer metric readers.

The program stamps its spans with `time.time_ns()`, the clock of
kineto's events, and keeps them on while a torch.profiler records: the
traced window carries them with no call from the harness.  A program
without the module (an older checkout) has none, and every reader here
returns None.

Attribution: a device kernel belongs to the innermost program span whose
host interval holds its launch event (the runtime or driver call with
the kernel's correlation id), whatever the launching thread: autograd's
device thread launches the backward while the main thread waits inside
`step.backward`.  A kernel whose launch the trace lacks takes the span of
its nearest attributed neighbours on its stream when both have the same
one; else it is unattributed.  A span's device time includes its child
spans'.

`Record` keeps no correlation ids, so `window_events` takes the kineto
events from the traced run's `trace.Profiler`, found among the callers'
locals (the harness's `run_cell` holds it while the readers run).  It
stands in until `Record` carries the correlation ids and launch events
itself, and goes then.  A card run with program spans and no Profiler
among the callers raises, so that moving the readers' call away from
`run_cell` cannot drop the device metrics in silence.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from mdd_bench import trace

STEP = "loop.step"
LAUNCH = re.compile(r"^cu(da)?[A-Z]")
# the host waiting on the card: a full command queue, a synchronising call
WAIT = re.compile(r"^(Command[ _]Buffer[ _]Full|cudaStreamSynchronize|"
                  r"cudaDeviceSynchronize|cudaEventSynchronize|cudaMemcpy|"
                  r"cuStreamSynchronize|cuCtxSynchronize|cuEventSynchronize)$")


@dataclasses.dataclass(frozen=True)
class Kernel:
    name: str
    start: int
    end: int
    corr: int
    stream: tuple


def program_trace() -> Optional[dict]:
    """The program's snapshot (spans and counters), or None where the
    program has no tracing module."""
    try:
        from mdd_tpu_torch.utils import trace as program
    except ImportError:
        return None
    return program.snapshot()


def window_events() -> Optional[list]:
    """The traced window's kineto events, from the `trace.Profiler` that a
    caller holds; None if none does."""
    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, trace.Profiler):
                return value.events
        frame = frame.f_back
    return None


def split(events) -> Tuple[List[Kernel], Dict[int, int]]:
    """-> (the device kernels, as `Record.kernels` has them; {correlation
    id: start ns} of the host's runtime and driver calls)."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    kernels, launches = [], {}
    for e in events:
        if e.device_type() == cpu:
            if LAUNCH.match(e.name()):
                launches.setdefault(e.correlation_id(), e.start_ns())
        elif (not e.is_user_annotation() and e.end_ns() > e.start_ns()
              and trace.is_kernel(e.name())):
            kernels.append(Kernel(e.name(), e.start_ns(), e.end_ns(),
                                  e.correlation_id(),
                                  (e.device_index(), e.device_resource_id())))
    return kernels, launches


def innermost(spans: Sequence[dict], starts: Sequence[int],
              t: int) -> Optional[dict]:
    """The latest-opened span holding time `t` (`spans` sorted by start,
    `starts` their starts)."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if spans[i]["end_ns"] >= t:
            return spans[i]
        i -= 1
    return None


def attribute(kernels: Sequence[Kernel], launches: Dict[int, int],
              spans: Sequence[dict]) -> List[Optional[dict]]:
    """Each kernel's program span (None: unattributed), by the rule in the
    module's docstring."""
    spans = sorted(spans, key=lambda s: s["start_ns"])
    starts = [s["start_ns"] for s in spans]
    out: List[Optional[dict]] = []
    for k in kernels:
        t = launches.get(k.corr)
        out.append(None if t is None else innermost(spans, starts, t))
    by_stream: Dict[tuple, List[int]] = {}
    for i, k in enumerate(kernels):
        by_stream.setdefault(k.stream, []).append(i)
    for order in by_stream.values():
        order.sort(key=lambda i: kernels[i].start)
        known = [i for i in order if out[i] is not None]
        pos = {i: n for n, i in enumerate(order)}
        where = [pos[i] for i in known]
        for i in order:
            if kernels[i].corr in launches:
                continue
            j = bisect.bisect_left(where, pos[i])
            if 0 < j < len(known):
                before, after = out[known[j - 1]], out[known[j]]
                if before["id"] == after["id"]:
                    out[i] = before
    return out


def device_ns(kernels: Sequence[Kernel], owners: Sequence[Optional[dict]],
              spans: Sequence[dict]) -> Tuple[Dict[str, int], Dict[str, int]]:
    """-> ({span name: device ns of the kernels under it, its child spans'
    included}, {kernel name: device ns of the unattributed})."""
    parent = {s["id"]: s["parent"] for s in spans}
    name = {s["id"]: s["name"] for s in spans}
    under: Dict[str, int] = {}
    lost: Dict[str, int] = {}
    for k, owner in zip(kernels, owners):
        ns = k.end - k.start
        if owner is None:
            lost[k.name] = lost.get(k.name, 0) + ns
            continue
        seen, sid = set(), owner["id"]
        while sid is not None:
            if name[sid] not in seen:
                seen.add(name[sid])
                under[name[sid]] = under.get(name[sid], 0) + ns
            sid = parent.get(sid)
    return under, lost


_last: tuple = (None, None)


def phases(rec) -> Optional[dict]:
    """The traced window's attribution, once a record: {"under": {span
    name: ns}, "unattributed": {kernel name: ns}, "kernels": n, "launched":
    n with a launch event}; None without a card or program spans."""
    global _last
    if _last[0] is rec:
        return _last[1]
    prog = program_trace()
    result = None
    if prog and prog["spans"] and rec.kernels:
        events = window_events()
        if events is None:
            raise RuntimeError(
                "a card run with program spans, and no trace.Profiler "
                "among the readers' callers to take the launch events from")
        kernels, launches = split(events)
        if kernels:
            owners = attribute(kernels, launches, prog["spans"])
            under, lost = device_ns(kernels, owners, prog["spans"])
            result = {"under": under, "unattributed": lost,
                      "kernels": len(kernels),
                      "launched": sum(k.corr in launches for k in kernels)}
    _last = (rec, result)
    return result


def phase_ms(rec, name: str) -> Optional[float]:
    """Device ms a step of the kernels under the program's spans `name`."""
    got = phases(rec)
    if got is None or not rec.steps:
        return None
    return got["under"].get(name, 0) / 1e6 / rec.steps


def _overlap(runs: Sequence[Tuple[int, int]], a: int, b: int) -> int:
    return sum(max(0, min(e, b) - max(s, a)) for s, e in runs)


def dispatch_ms(rec, spans: Optional[Sequence[dict]] = None
                ) -> Optional[float]:
    """Host ms a `loop.step` span of the window lasts, less the time in it
    that the host waited on the card (any thread's `WAIT` events); None
    without a card.  `spans`: the program's (default: its snapshot)."""
    if not rec.kernels or not rec.host:
        return None
    if spans is None:
        prog = program_trace()
        spans = prog["spans"] if prog else []
    lo = min(s for _, s, _ in rec.host)
    hi = max(e for _, _, e in rec.host)
    steps = [s for s in spans if s["name"] == STEP
             and lo <= s["start_ns"] and s["end_ns"] <= hi]
    if not steps:
        return None
    waits = trace.merge([e for e in rec.host if WAIT.match(e[0])])
    host = sum(s["end_ns"] - s["start_ns"]
               - _overlap(waits, s["start_ns"], s["end_ns"]) for s in steps)
    return host / 1e6 / len(steps)


def h2d_kib(rec) -> Optional[float]:
    """KiB the program put on the device a train step (`h2d_bytes` over
    the `loop.step` spans of the same time)."""
    prog = program_trace()
    if not prog:
        return None
    steps = sum(s["name"] == STEP for s in prog["spans"])
    if not steps or "h2d_bytes" not in prog["counters"]:
        return None
    return prog["counters"]["h2d_bytes"] / steps / 1024
