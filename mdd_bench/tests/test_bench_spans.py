"""The readers of the program's spans and counters (spans.py): the
attribution rule on synthetic kineto events, the host's waits taken out
of `dispatch_ms`, and a small traced run on the CPU, where the program's
counter reads and the device readers give nothing."""

import math

import pytest
import torch

from mdd_bench import harness, spans, trace
from mdd_bench.tests import small

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    """The part of a kineto event that spans.split reads."""

    def __init__(self, name, start, end, corr, device=CPU, stream=7,
                 thread=1):
        self._v = dict(name=name, start_ns=start, end_ns=end,
                       correlation_id=corr, device_type=device,
                       device_index=0 if device == CUDA else -1,
                       device_resource_id=stream if device == CUDA else thread,
                       start_thread_id=thread, is_user_annotation=False)

    def __getattr__(self, key):
        return lambda: self._v[key]


def _span(sid, name, start, end, parent=None, step=0, thread=1):
    return dict(id=sid, name=name, start_ns=start, end_ns=end, parent=parent,
                step=step, thread=thread)


SPANS = [_span(0, "data.gather", 50, 95),
         _span(1, "loop.step", 100, 1000),
         _span(2, "step.forward", 110, 300, 1),
         _span(3, "step.loss", 300, 400, 1),
         _span(4, "step.backward", 400, 900, 1),
         _span(5, "step.optimizer", 900, 990, 1)]


def _kernels():
    """(kernel name, launch time or None, device start) in stream order;
    `b.thread` is launched by another thread than the spans'."""
    return [("g", 60, 2000), ("f", 150, 2100), ("l", 350, 2200),
            ("b.thread", 500, 2300), ("b.nolaunch", None, 2400),
            ("b", 600, 2500), ("gap", None, 2600), ("o", 950, 2700),
            ("step.self", 995, 2800)]


def _events():
    events = [Ev("Memcpy HtoD (Pageable -> Device)", 1900, 1950, 99,
                 device=CUDA)]
    for corr, (name, launch, start) in enumerate(_kernels()):
        events.append(Ev(name, start, start + 10 * (corr + 1), corr,
                         device=CUDA))
        if launch is not None:
            thread = 2 if name == "b.thread" else 1
            events.append(Ev("cudaLaunchKernel", launch, launch + 3, corr,
                             thread=thread))
    # a kernel alone on another stream, with no launch event
    events.append(Ev("lonely", 3000, 3005, 50, device=CUDA, stream=9))
    return events


def test_each_kernel_goes_to_the_innermost_span_of_its_launch():
    kernels, launches = spans.split(_events())
    assert [k.name for k in kernels] == [n for n, _, _ in _kernels()] + [
        "lonely"]                       # the memcpy is no kernel
    owners = spans.attribute(kernels, launches, SPANS)
    got = {k.name: (o["name"] if o else None)
           for k, o in zip(kernels, owners)}
    assert got == {"g": "data.gather", "f": "step.forward",
                   "l": "step.loss", "b.thread": "step.backward",
                   "b.nolaunch": "step.backward", "b": "step.backward",
                   "gap": None, "o": "step.optimizer",
                   "step.self": "loop.step", "lonely": None}
    under, lost = spans.device_ns(kernels, owners, SPANS)
    dur = {k.name: k.end - k.start for k in kernels}
    assert under["step.backward"] == (dur["b.thread"] + dur["b.nolaunch"]
                                      + dur["b"])
    assert under["loop.step"] == sum(
        dur[n] for n in ("f", "l", "b.thread", "b.nolaunch", "b", "o",
                         "step.self"))
    assert under["data.gather"] == dur["g"]
    assert lost == {"gap": dur["gap"], "lonely": dur["lonely"]}


def _record(host):
    return trace.Record(
        cfg={}, stats=[harness.StepStat(512, 4, 100, [50], [20], 0.001)],
        window_s=1.0, card="NVIDIA H100 80GB HBM3", cards=1, flops=0.0,
        peak_window_bytes=0, events=[("k", 150, 160)], host=host)


def test_dispatch_leaves_out_the_hosts_waits_on_the_card():
    steps = [_span(1, "loop.step", 1_000_000, 3_000_000),
             _span(9, "loop.step", 4_000_000, 5_000_000, step=1)]
    host = [("aten::mm", 500_000, 5_500_000),
            # two threads' full queues overlapping: counted once
            ("Command Buffer Full", 1_200_000, 1_700_000),
            ("Command Buffer Full", 1_500_000, 2_000_000),
            ("cudaLaunchKernel", 2_100_000, 2_110_000),
            # partly outside the step: the inside part only
            ("cudaStreamSynchronize", 2_900_000, 3_400_000)]
    got = spans.dispatch_ms(_record(host), steps)
    assert got == pytest.approx(((2.0 - 0.8 - 0.1) + 1.0) / 2)
    assert spans.dispatch_ms(_record(host), []) is None
    cpu = _record(host)
    cpu.events = []
    assert spans.dispatch_ms(cpu, steps) is None


def test_device_readers_take_the_launches_from_the_callers_profiler(
        monkeypatch):
    """phase_ms finds the window's events on a caller's trace.Profiler;
    a card run with program spans and no such caller raises, and one
    without program spans (a checkout older than them) reads nothing."""
    monkeypatch.setattr(spans, "program_trace",
                        lambda: {"spans": SPANS, "counters": {}})
    with pytest.raises(RuntimeError, match="no trace.Profiler"):
        spans.phase_ms(_record([]), "step.forward")
    prof = trace.Profiler.__new__(trace.Profiler)
    prof.events = _events()
    rec = _record([])
    assert spans.phase_ms(rec, "step.forward") == pytest.approx(20 / 1e6)
    assert spans.phase_ms(rec, "step.backward") == pytest.approx(
        (40 + 50 + 60) / 1e6)
    monkeypatch.setattr(spans, "program_trace",
                        lambda: {"spans": [], "counters": {}})
    assert spans.phase_ms(_record([]), "step.forward") is None
    del prof


def test_a_small_traced_run_reads_the_programs_counter_on_the_cpu():
    res = harness.run_cell(small.CELL, 2 ** 31 + 77, 120.0, True,
                           device="cpu", cfg_override=small.CFG,
                           mix_override=small.MIX)
    got = res["metrics"]
    kib = got["h2d_kib.train"]
    assert kib["unit"] == "KiB" and math.isfinite(kib["value"])
    assert kib["value"] > 0
    for name in ("forward_ms.train", "loss_ms.train", "backward_ms.train",
                 "optimizer_ms.train", "gather_ms.train",
                 "dispatch_ms.train"):
        assert name not in got
