"""One run of a training cell.

Set-up builds the program as `python -m mdd_tpu_torch train` builds it
from a recipe with `device_cache: true` (`cli.build_trainer`,
`cli._build_loader`: a `Trainer` and a `CachedLoader` over a
`DeviceFeatureCache` of the corpus written under TMPDIR), installs the
benchmark's weights, and drives that same Trainer through its first steps
with `Trainer.run_epoch` over the window's own feed, capturing what the
step produces for the comparison.  It then runs whole epochs to warm up
every shape the traffic uses.  The window drives `run_epoch` epoch after
epoch until `seconds` have passed (ranks of a process group: until the
end of the first epoch that one of them finished past it); a CUDA event
recorded on the stream at every step boundary times each step without a
host sync.  The window ends with a synchronize after the last step.

After the window, with the program's state freed, the reference works out
the captured steps again (reference.py) and `compare.judge` decides
`correct`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from mdd_bench import (compare, corpus, flops, manifest, ranks, reference,
                       trace)
from mdd_bench.weights import make_weights


def stderr(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class StepStat:
    bucket: int
    rows: int                   # this rank's slots
    real_frames: int            # raw frames of the real rows
    frames: List[int]           # spliced model frames of each real row
    trans_lens: List[int]       # transcript length of each real row
    host_s: float               # host time to get the batch


class Feed:
    """The loader the window drives: the program's CachedLoader, passed
    through.  It counts each batch, times the loader on the host, marks
    each step boundary with an event on the device's stream, and ends the
    epoch at `deadline` (host clock) or after `limit` steps."""

    def __init__(self, loader, cfg: dict, device: torch.device):
        self.loader = loader
        self.cache = loader.cache
        self.batch_size = loader.batch_size
        self.cfg = cfg
        self.cuda = device.type == "cuda"
        self.marks: list = []
        self.stats: List[StepStat] = []
        self.deadline: Optional[float] = None
        self.limit: Optional[int] = None
        self.finished = False
        self.span = contextlib.nullcontext   # the traced run's spans

    def arm(self, deadline: Optional[float] = None,
            limit: Optional[int] = None) -> None:
        self.marks, self.stats = [], []
        self.deadline, self.limit, self.finished = deadline, limit, False

    def _mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def close(self) -> None:
        """End the window after the last step given."""
        self._mark()
        self.finished = True

    def _done(self) -> bool:
        return ((self.limit is not None and len(self.stats) >= self.limit)
                or (self.deadline is not None
                    and time.perf_counter() >= self.deadline))

    def __iter__(self):
        it = iter(self.loader)
        while True:
            if self._done():
                self.close()
                return
            self._mark()
            t0 = time.perf_counter()
            with self.span("data.next_batch"):
                batch = next(it, None)
            host_s = time.perf_counter() - t0
            if batch is None:
                # the epoch's end: the last step's interval runs on to
                # the next epoch's first mark
                self.marks.pop()
                return
            real = batch.valid.astype(bool)
            lens = batch.lengths[real]
            self.stats.append(StepStat(
                int(batch.bucket), int(batch.size), int(lens.sum()),
                [flops.model_frames(self.cfg, int(t)) for t in lens],
                [int(n) for n in batch.trans_sizes[real]], host_s))
            yield batch

    def step_seconds(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy, never a view of the program's tensor."""
    return t.detach().to("cpu", copy=True)


class Capture:
    """What the program produces in its first steps, taken from the
    Trainer itself: each step's arrays (its `cached_arrays`), log-probs (a
    forward hook on the model), loss and WER counts (its `_acc_update`),
    the first step's gradient as Adam took it (Adam's first moment after
    one step over 1 - beta1) and the parameters after the last step."""

    def __init__(self, trainer, n_steps: int):
        self.trainer, self.n = trainer, n_steps
        self.arrays, self.log_probs, self.loss = [], [], []
        self.errs, self.tokens = [], []
        self.grad1: Dict[str, torch.Tensor] = {}
        self.params: Dict[str, torch.Tensor] = {}
        inner_arrays, inner_acc = trainer.cached_arrays, trainer._acc_update

        def cached_arrays(cache, batch):
            arrays = inner_arrays(cache, batch)
            self.arrays.append(tuple(_host(a) for a in arrays))
            return arrays

        def acc_update(acc, loss, errs, tokens):
            self.loss.append(_host(loss.float()))
            self.errs.append(_host(errs))
            self.tokens.append(_host(tokens))
            self._after_step(len(self.loss))
            return inner_acc(acc, loss, errs, tokens)

        self._hook = trainer.model.register_forward_hook(
            lambda mod, args, out: self.log_probs.append(_host(out)))
        trainer.cached_arrays = cached_arrays
        trainer._acc_update = acc_update

    def _after_step(self, step: int) -> None:
        named = dict(self.trainer.model.named_parameters())
        if step == 1:
            state = self.trainer.optimizer.state
            beta1 = self.trainer.optimizer.param_groups[0]["betas"][0]
            self.grad1 = {k: _host(state[p]["exp_avg"] / (1 - beta1))
                          if p in state else torch.zeros(p.shape)
                          for k, p in named.items()}
        if step == self.n:
            self.params = {k: _host(p) for k, p in named.items()}

    def remove(self) -> None:
        self._hook.remove()
        del self.trainer.cached_arrays
        del self.trainer._acc_update


class Phases:
    """Seconds of each part of the set-up, for the log."""

    def __init__(self, t0: float):
        self.t, self.parts = t0, []

    def done(self, name: str) -> None:
        now = time.time()
        self.parts.append((name, now - self.t))
        self.t = now

    def line(self) -> str:
        return ", ".join(f"{n} {s:.2f} s" for n, s in self.parts)


def process_start_time() -> float:
    """The wall time at which this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/stat") as f:
        btime = next(int(ln.split()[1]) for ln in f
                     if ln.startswith("btime"))
    return btime + start_ticks / os.sysconf("SC_CLK_TCK")


def _port_config(cfg: dict, mix: dict, seed: int, paths: dict):
    """The port's Config of the recipe, as `load_config` reads a YAML."""
    from mdd_tpu_torch.utils.config import Config

    port = Config()
    for k, v in cfg.items():
        if hasattr(port, k):
            if isinstance(getattr(port, k), tuple):
                v = tuple(tuple(e) for e in v)
            setattr(port, k, v)
    port.batch_size = mix["batch_size"]
    port.shuffle_train = mix["shuffle"]
    port.seed = seed
    for k, v in paths.items():
        setattr(port, k, v)
    return port


def quiet(*_a, **_k) -> None:
    """run_epoch's log, silenced: its lines would only slow the host."""


def run_cell(cell: str, seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", bench: Optional[dict] = None,
             cfg_override: Optional[dict] = None,
             mix_override: Optional[dict] = None,
             limits: Optional[dict] = None,
             detail: Optional[dict] = None) -> dict:
    """Run the cell; -> the result line's object.  `cfg_override` and
    `mix_override` replace keys of the configuration and the mix, and
    `limits` the cell's limits (the tests' small sizes); `detail`
    receives the comparison's detail (compare.judge)."""
    from mdd_tpu_torch import cli
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.parallel import mesh

    t_proc = process_start_time()
    bench = manifest.load() if bench is None else bench
    work = manifest.workload(bench, cell)
    cfg = dict(manifest.config(work["config"]), **(cfg_override or {}))
    mix = dict(manifest.traffic(work["traffic"]), **(mix_override or {}))
    rank, world = mesh.process_index(), mesh.process_count()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    phases = Phases(t_proc)
    phases.done("start, imports")
    # the corpus, written where the program reads it; rank 0 writes it
    data = corpus.generate(mix, cfg["units"], seed, dev) if rank == 0 \
        else None
    tmp = tempfile.mkdtemp(prefix="mdd_bench_") if rank == 0 else None
    tmp = ranks.broadcast_object(tmp)
    phases.done("corpus")
    try:
        if rank == 0:
            paths = corpus.write(data, Path(tmp))
        ranks.barrier()
        phases.done("corpus written")
        paths = corpus.paths(Path(tmp))
        port = _port_config(cfg, mix, seed, paths)
        vocab = Vocab.from_units_file(paths["vocab_file"])
        trainer = cli.build_trainer(port, vocab, str(dev))
        phases.done("trainer")
        loader = cli._build_loader(port, vocab, paths["train_scp_path"],
                                   paths["train_lab_path"],
                                   paths["train_trans_path"], train=True,
                                   device=str(dev))
    finally:
        ranks.barrier()
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
    phases.done("device cache")
    weights = make_weights(cfg, seed, dev)
    with torch.no_grad():
        for name, p in trainer.model.named_parameters():
            p.copy_(weights[name])
    w0 = {k: v.cpu() for k, v in weights.items()} if rank == 0 else None
    del weights
    phases.done("weights")

    feed = Feed(loader, cfg, dev)
    n_check = int(mix["correctness_steps"])
    cap = Capture(trainer, n_check)
    feed.arm(limit=n_check)
    trainer.run_epoch(feed, 0, True, port.verbose_step, quiet)
    cap.remove()
    phases.done("first steps")
    for _ in range(int(mix["warmup_epochs"])):
        feed.arm()
        trainer.run_epoch(feed, 0, True, port.verbose_step, quiet)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    phases.done("warm-up")

    # the window
    ranks.barrier()
    peak_setup = trace.max_memory(dev)
    trace.reset_memory(dev)
    prof = trace.Profiler(dev) if trace_on else None
    if prof is not None:
        from torch.profiler import record_function

        trace.install_spans(trainer)
        feed.span = record_function
        prof.start()
    t0 = time.time()
    setup_s = t0 - t_proc
    if rank == 0:
        stderr("setup " + phases.line())
    # one process stops at the deadline, at whatever step it reaches;
    # ranks stop together, at the end of the first epoch that any of them
    # finished past it (each rank's host reaches the deadline at its own
    # step, and a rank that stopped alone would leave the others waiting
    # in a collective)
    deadline = time.perf_counter() + seconds
    feed.arm(deadline=deadline if world == 1 else None,
             limit=int(mix["trace_steps"]) if trace_on else None)
    failed = 0
    while not feed.finished:
        before = len(feed.stats)
        _, loss = trainer.run_epoch(feed, 0, True, port.verbose_step, quiet)
        if not math.isfinite(loss):
            failed += len(feed.stats) - before
        if world > 1 and not feed.finished and ranks.all_max(
                float(time.perf_counter() >= deadline)):
            feed.close()
    sync()
    window_s = time.time() - t0
    if prof is not None:
        prof.stop()
    steps = feed.step_seconds()
    peak_window = trace.max_memory(dev)
    memory_peak = ranks.all_max(max(peak_setup, peak_window))
    del trainer, loader, feed.loader, feed.cache, cap.trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    stats = feed.stats
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    totals = ranks.all_sum([float(sum(s.real_frames for s in stats)),
                            float(sum(flops.train_step_flops(
                                cfg, 1, f, n) for s in stats
                                for f, n in zip(s.frames, s.trans_lens)))])
    real_frames, step_flops = totals
    result = {"correct": False, "attempted": len(stats), "failed": failed,
              "metrics": {}, "device": {
                  "platform": "gpu" if dev.type == "cuda" else "cpu",
                  "kind": card, "count": world,
                  "memory_peak_bytes": int(memory_peak)}}
    if trace_on:
        rec = trace.Record(
            cfg=cfg, stats=stats, window_s=window_s, card=card,
            cards=world, flops=step_flops, peak_window_bytes=peak_window,
            events=prof.device_ops(), host=prof.host_ops())
        busy = ranks.all_mean(rec.busy_s)
        result["device"]["busy_s"] = busy
        result["device"]["window_s"] = window_s
        result["metrics"] = trace.per_layer(bench, cell, rec)
        result["breakdown"] = rec.breakdown()
    else:
        frame_s = float(mix["frame_shift_s"])
        result["metrics"] = {
            "train_audio_s_per_s": {"value": real_frames * frame_s / window_s,
                                    "unit": "audio_s/s"},
            "train_step_p95_ms": {
                "value": float(np.percentile(steps, 95)) * 1e3 if steps
                else float("nan"), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    # the comparison, on rank 0, once the program's state is freed
    prog = compare.gather_program(cap, world)
    if rank == 0:
        t_ref = time.time()
        batches = reference.first_batches(data, cfg, mix, seed, n_check)
        ref = reference.run_steps(data, cfg, batches, w0, seed, dev,
                                  world=world)
        checks = compare.judge(prog, ref, batches, w0,
                               limits or manifest.limits(cell),
                               rows=prog["rows"], detail=detail)
        result["correct"] = all(c["value"] <= c["limit"]
                                for c in checks.values())
        result["checks"] = checks
        stderr(f"comparison {time.time() - t_ref:.2f} s")
    ranks.barrier()
    return result
