"""The port's spans and counters (mdd_tpu_torch/utils/trace.py) on a tiny
CPU Trainer over the device-resident corpus: off, nothing is recorded
and `record_function` is never entered; on, a train step's phases nest
under `loop.step` with one step id, `h2d_bytes` counts the arrays put,
the loader and the cache's build carry their spans; under the CPU
profiler each span's stamps meet its `record_function` twin's, and
`train --profile-dir` writes them into its trace."""

import gc
import json
import statistics
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mdd_tpu_torch import cli
from mdd_tpu_torch.data.dataset import SpeechDataset
from mdd_tpu_torch.data.device_cache import CachedLoader, DeviceFeatureCache
from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.models.ctc_model import ModelConfig
from mdd_tpu_torch.ops import build
from mdd_tpu_torch.train.loop import Trainer
from mdd_tpu_torch.utils import trace
from test_torch_data import UNITS, write_corpus
from test_torch_train_cli import _yaml

TINY = dict(input_dim=243, num_class=len(UNITS) + 2, conv_channels=(4, 4),
            rnn_hidden_size=16, rnn_layers=2, text_embed_size=8,
            text_vocab_size=len(UNITS) + 4, use_pallas_lstm=True,
            dropout=0.0)
PHASES = {"step.forward", "step.loss", "step.backward", "step.optimizer"}
# kineto's record_function event and the span's own stamps: the median
# gap, and how far either may cross the other
TWIN_NS = 200_000
TWIN_SLACK_NS = 20_000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("trace_corpus"), "train", 12,
                        seed=6, frames=(3, 9))


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _cache(corpus):
    ds = SpeechDataset(Vocab(UNITS), *corpus, train=True, augment_mode=2,
                       mutation_prob=0.3, device_frontend=True)
    return DeviceFeatureCache(ds, "cpu", time_quantum=8,
                              wire_dtype="bfloat16")


def _loader(corpus):
    return CachedLoader(_cache(corpus), 4, shuffle=True, seed=3,
                        label_quantum=4)


def _trainer():
    return Trainer(ModelConfig(**TINY), seed=5, device="cpu",
                   device_frontend=True)


def _spans(name=None):
    spans = trace.snapshot()["spans"]
    return [s for s in spans if name is None or s["name"] == name]


def test_off_records_nothing_and_never_enters_record_function(
        corpus, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    loader = _loader(corpus)
    trainer = _trainer()
    batch = next(iter(loader))
    trainer.train_step(trainer.cached_arrays(loader.cache, batch),
                       torch.zeros(4))
    assert trace.snapshot() == {"spans": [], "counters": {}}
    assert trace.open_spans() == 0


def test_a_train_step_nests_its_phases_under_one_step(corpus):
    loader = _loader(corpus)
    trainer = _trainer()
    batch = next(iter(loader))
    trace.enable()
    trainer.train_step(trainer.cached_arrays(loader.cache, batch),
                       torch.zeros(4))
    (step,) = _spans("loop.step")
    children = [s for s in _spans() if s["parent"] == step["id"]]
    assert {s["name"] for s in children} == PHASES
    assert [s["name"] for s in children].count("step.optimizer") == 2
    for s in children:
        assert step["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= step["end_ns"]
        assert s["step"] == step["step"] and s["thread"] == step["thread"]
    (gather,) = _spans("data.gather")
    assert gather["parent"] is None and gather["step"] == step["step"]
    assert gather["end_ns"] <= step["start_ns"]
    # the next step's spans carry the next id
    trainer.train_step(trainer.cached_arrays(loader.cache, batch),
                       torch.zeros(4))
    assert [s["step"] for s in _spans("loop.step")] == [step["step"],
                                                        step["step"] + 1]


def test_h2d_bytes_counts_the_arrays_put(corpus):
    loader = _loader(corpus)
    trainer = _trainer()
    batch = next(iter(loader))
    trace.enable()
    trainer.cached_arrays(loader.cache, batch)
    put = (batch.idx, batch.lengths, batch.aug, batch.targets,
           batch.target_sizes, batch.trans, batch.trans_sizes, batch.valid)
    assert trace.snapshot()["counters"] == {
        "h2d_bytes": sum(a.nbytes for a in put)}


def test_the_cached_loader_makes_each_batch_in_one_span(corpus):
    loader = _loader(corpus)
    trace.enable()
    batches = list(loader)
    made = _spans("data.make_batch")
    assert len(made) == len(batches) == len(loader) > 1
    assert all(s["parent"] is None for s in made)


def test_set_up_spans_wrap_the_builds(corpus, tmp_path, monkeypatch):
    trace.enable()
    t0 = time.time_ns()
    cache = _cache(corpus)
    t1 = time.time_ns()
    (built,) = _spans("setup.device_cache")
    assert t0 <= built["start_ns"] <= built["end_ns"] <= t1
    assert cache.buckets
    trace.reset()
    # a compile that ran, and one that was found built
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)

    class Done:
        returncode = 0

        def communicate(self):
            return "ptxas info", None

    out = build.library_path("wer.cu")
    build._tmp_path(out).write_bytes(b"")
    assert build.finish_build("wer.cu", Done()) == "ptxas info"
    assert build.finish_build("wer.cu", None) == ""
    assert [s["name"] for s in _spans()] == ["kernel.build"]


def test_build_trainer_is_one_set_up_span(tmp_path):
    from mdd_tpu_torch.utils.config import load_config

    cfg = load_config(_yaml(tmp_path, 1))
    trace.enable()
    trainer = cli.build_trainer(cfg, Vocab(UNITS), "cpu")
    (built,) = _spans("setup.trainer")
    assert built["parent"] is None and trainer.model is not None


def _twins(prof):
    """Kineto's record_function events by name, in order of start."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name() in trace_names():
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return {k: sorted(v) for k, v in out.items()}


def trace_names():
    return PHASES | {"loop.epoch", "loop.step", "loop.fetch", "data.gather",
                     "data.make_batch"}


def test_stamps_lie_within_their_twins_under_the_profiler(corpus):
    """Profiling alone turns the spans on (no enable()), on kineto's
    clock.  The stamps are taken just outside the record_function's, so
    each span holds its twin: an offset between the two clocks of more
    than TWIN_SLACK_NS would break that for the tightest spans (1-20 us
    apart).  Each gap is the stamp-to-stamp time, which a descheduled
    thread stretches to milliseconds on a loaded machine, so the 200 us
    bound holds for the median gap.  A session's first annotation pays
    kineto's one-time cost and a collection can pause either stamp: one
    throwaway annotation opens the window and the collector waits."""
    loader = _loader(corpus)
    trainer = _trainer()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("warm"):
                pass
            trainer.run_epoch(loader, 1, True, log=lambda *_: None)
    finally:
        gc.enable()
    twins = _twins(prof)
    assert set(twins) == trace_names()
    gaps = []
    for name, kin in twins.items():
        ours = sorted((s["start_ns"], s["end_ns"]) for s in _spans(name))
        assert len(ours) == len(kin), name
        for (a, b), (ka, kb) in zip(ours, kin):
            assert a <= ka + TWIN_SLACK_NS and kb <= b + TWIN_SLACK_NS, name
            gaps += [ka - a, b - kb]
    assert statistics.median(gaps) < TWIN_NS


def test_toggling_between_epochs_leaves_no_open_span(corpus):
    loader = _loader(corpus)
    trainer = _trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for on in (True, False, True):
            (trace.enable if on else trace.disable)()
            trainer.run_epoch(loader, 1, True, log=lambda *_: None)
    assert trace.open_spans() == 0
    spans = _spans()
    ids = {s["id"] for s in spans}
    assert all(s["parent"] is None or s["parent"] in ids for s in spans)
    assert len(_spans("loop.epoch")) == 3
    assert len(_spans("loop.step")) == 3 * len(loader)
    twins = _twins(prof)
    assert sum(map(len, twins.values())) == sum(
        s["name"] in trace_names() for s in spans)
    assert all(a <= b for v in twins.values() for a, b in v)


def test_profile_dir_trace_carries_the_spans(tmp_path):
    conf = _yaml(tmp_path, 1, device_cache=True, num_workers=0)
    prof = tmp_path / "prof"
    assert cli.main(["train", "--conf", conf, "--device", "cpu",
                     "--profile-dir", str(prof)]) == 0
    events = json.loads((prof / "trace_rank0.json").read_text())[
        "traceEvents"]
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    # the profile opens before the set-up: the Trainer's and the device
    # cache's builds are in it
    assert trace_names() | {"setup.trainer", "setup.device_cache"} <= names
