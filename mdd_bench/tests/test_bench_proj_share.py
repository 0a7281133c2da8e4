"""proj_bf16_share.train: the program's two projection counters read as
a share, nothing where the program has neither (a checkout older than
them), and 100 in a small traced bf16 run on the CPU."""

import pytest

from mdd_bench import harness, spans, trace
from mdd_bench.tests import small

READ = trace.load_reader("proj_bf16_share.train")


@pytest.mark.parametrize("counters,share", [
    ({"proj.bf16_products": 30, "proj.f32_products": 0}, 100.0),
    ({"proj.bf16_products": 30}, 100.0),
    ({"proj.bf16_products": 18, "proj.f32_products": 6}, 75.0),
    ({"proj.f32_products": 24, "h2d_bytes": 4096}, 0.0),
    ({"h2d_bytes": 4096}, None),
    ({}, None),
])
def test_reads_the_counters_of_a_snapshot(monkeypatch, counters, share):
    monkeypatch.setattr(spans, "program_trace",
                        lambda: {"spans": [], "counters": counters})
    assert READ(None) == share


def test_a_program_without_tracing_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, "program_trace", lambda: None)
    assert READ(None) is None


def test_a_small_traced_bf16_run_reads_100_on_the_cpu():
    res = harness.run_cell(small.CELL, 2 ** 31 + 91, 120.0, True,
                           device="cpu", cfg_override=small.CFG,
                           mix_override=small.MIX)
    got = res["metrics"]["proj_bf16_share.train"]
    assert got == {"value": 100.0, "unit": "%"}
