"""The traced run: torch.profiler over the window, the benchmark's own
spans around its calls into the program's layers, and the record the
per-layer metric readers (metrics/<name>.py) read.

Spans: `data.next_batch` (the CachedLoader yielding a batch, from the
feed), `data.cached_arrays` (the batch gathered and masked on the device),
`model.train_step` (forward, loss, backward, Adam) and `train.fetch`
(run_epoch's read of the metric accumulator), the last three by wrapping
the Trainer's methods on the instance for the traced run only.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch

from mdd_bench import flops, manifest

Event = Tuple[str, int, int]        # (name, start ns, end ns)


def install_spans(trainer) -> None:
    from torch.profiler import record_function

    def wrap(name, fn):
        @functools.wraps(fn)
        def spanned(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return spanned

    trainer.cached_arrays = wrap("data.cached_arrays", trainer.cached_arrays)
    trainer.train_step = wrap("model.train_step", trainer.train_step)
    trainer._fetch = wrap("train.fetch", trainer._fetch)


class Profiler:
    """torch.profiler over the window: the host's ops and, on a card, the
    device's."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.events: List = []

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()
        self.events = list(self.prof.profiler.kineto_results.events())

    def _ops(self, device: bool) -> List[Event]:
        """The host's or the device's events; a span's copy on the
        device's timeline (a user annotation) is no device operation."""
        out = []
        for e in self.events:
            on_device = e.device_type() != torch.autograd.DeviceType.CPU
            if on_device and e.is_user_annotation():
                continue
            if on_device == device and e.end_ns() > e.start_ns():
                out.append((e.name(), e.start_ns(), e.end_ns()))
        return out

    def device_ops(self) -> List[Event]:
        return self._ops(True)

    def host_ops(self) -> List[Event]:
        return self._ops(False)


def merge(events: List[Event]) -> List[Tuple[int, int]]:
    """The union of the events' intervals, as sorted disjoint runs."""
    runs: List[List[int]] = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if runs and s <= runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], e)
        else:
            runs.append([s, e])
    return [(s, e) for s, e in runs]


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


@dataclasses.dataclass
class Record:
    """What a traced run saw, for the per-layer metric readers."""

    cfg: dict
    stats: list                 # harness.StepStat of each traced step
    window_s: float             # host clock, first step to the sync
    card: str
    cards: int
    flops: float                # every rank's real rows' step FLOPs
    peak_window_bytes: int
    events: List[Event]         # device operations (this rank's card)
    host: List[Event]           # host operations and spans

    @property
    def steps(self) -> int:
        return len(self.stats)

    @property
    def kernels(self) -> List[Event]:
        return [e for e in self.events if is_kernel(e[0])]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in merge(self.events)) / 1e9

    def kernel_seconds(self, match) -> float:
        """Device seconds of the kernels whose name `match` accepts."""
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e9

    def idle_gaps(self) -> Dict[str, float]:
        """Seconds of device idle time between operations, by the
        innermost host operation or span open at each gap's middle (a
        sweep over the host's events, sorted by start)."""
        runs = merge(self.events)
        host = sorted(self.host, key=lambda x: x[1])
        out: Dict[str, float] = {}
        stack: List[Event] = []
        i = 0
        for (_, a), (b, _) in zip(runs, runs[1:]):
            mid = (a + b) // 2
            while i < len(host) and host[i][1] <= mid:
                while stack and stack[-1][2] < host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            name = stack[-1][0] if stack else "(no host op)"
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
        return out

    def breakdown(self) -> dict:
        ops: Dict[str, float] = {}
        for n, s, e in self.events:
            ops[n] = ops.get(n, 0.0) + (e - s) / 1e9
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], v] for n, v in top],
                "idle_gaps": [[n[:160], v] for n, v in gaps]}

    def lstm_roofline(self, which: str) -> Optional[float]:
        """The acoustic recurrence's least time over its kernels' device
        time, in %: `which` "fwd" or "bwd"."""
        names = {"fwd": ("lstm_fwd_kernel",),
                 "bwd": ("lstm_bwd_chain_kernel", "lstm_product_kernel",
                         "lstm_dw_reduce_kernel")}[which]
        spent = self.kernel_seconds(lambda n: any(k in n for k in names))
        if spent <= 0 or not self.cfg.get("use_pallas_lstm"):
            return None
        dtype = self.cfg["compute_dtype"]
        work = {"fwd": flops.lstm_fwd_work, "bwd": flops.lstm_bwd_work}[which]
        least = 0.0
        h = self.cfg["rnn_hidden_size"]
        for st in self.stats:
            t = flops.recurrence_steps(self.cfg, st.bucket)
            ops, byts = work(t, st.rows, h, dtype)
            one = flops.least_seconds(ops, byts, self.card, dtype)
            if one is None:
                return None
            least += self.cfg["rnn_layers"] * one
        return 100.0 * least / spent


def load_reader(name: str):
    """metrics/<name>.py's `read`."""
    return manifest.load_module(
        manifest.metric_file(name),
        "mdd_bench_metric_" + name.replace(".", "_").replace("-", "_")).read


def per_layer(bench: dict, cell: str, rec: Record) -> dict:
    """The cell's per-layer metrics that have something to read."""
    out = {}
    for m in manifest.per_layer_for(bench, cell):
        value = load_reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def max_memory(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def reset_memory(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
