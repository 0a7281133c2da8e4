"""A model family is taken by new files alone: a family file, a
configuration naming it and its cell's limits, dropped into a copy of
the benchmark, run through `harness.run_cell` at the small size with no
edit of a file that is there; and a family with no file is refused,
naming the families there are."""

import json
import shutil

import pytest

from mdd_bench import harness, manifest
from mdd_bench.tests import small
from mdd_bench.tests.test_bench_faults import LIMITS

INTERFACE = ("param_shapes", "spread", "forward", "ctc_sizes", "row_flops")

# re-exports cnn_bilstm's functions and counts the calls of each
STUB = '''
from mdd_bench import manifest

BASE = manifest.family({"name": "cnn_bilstm", "family": "cnn_bilstm"})
CALLS = {}


def _counted(name):
    inner = getattr(BASE, name)

    def call(*a, **k):
        CALLS[name] = CALLS.get(name, 0) + 1
        return inner(*a, **k)
    return call


''' + "\n".join(f"{n} = _counted({n!r})" for n in INTERFACE) + "\n"


@pytest.fixture()
def copy(tmp_path, monkeypatch):
    """The benchmark's files in tmp_path, where the lookups go."""
    here = tmp_path / "mdd_bench"
    shutil.copytree(manifest.HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "_cache"))
    monkeypatch.setattr(manifest, "HERE", here)
    monkeypatch.setattr(manifest, "_loaded", {})
    return here


def test_a_family_is_taken_by_files_alone(copy):
    (copy / "families" / "counted.py").write_text(STUB)
    cfg = json.loads((copy / "configs" / "attention_aug.json").read_text())
    cfg.update(name="counted_aug", family="counted")
    (copy / "configs" / "counted_aug.json").write_text(json.dumps(cfg))
    cell = "counted_aug.train_b256"
    (copy / "limits" / f"{cell}.json").write_text(json.dumps(LIMITS))
    bench = manifest.load()
    bench["configs"] = bench["configs"] + [dict(
        bench["configs"][0], name="counted_aug",
        file="mdd_bench/configs/counted_aug.json")]
    bench["workloads"] = bench["workloads"] + [dict(
        bench["workloads"][0], name=cell, config="counted_aug")]
    res = harness.run_cell(cell, 2 ** 31 + 23, 0.5, False, device="cpu",
                           bench=bench, cfg_override=small.CFG,
                           mix_override=small.MIX)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    calls = manifest.family({"family": "counted"}).CALLS
    assert {n for n in INTERFACE if calls.get(n)} == set(INTERFACE), calls


@pytest.mark.parametrize("family", ["conformer", None, "../reference",
                                    "__init__"])
def test_a_family_without_a_file_is_refused(copy, family):
    cfg = {"name": "wide"}
    if family is not None:
        cfg["family"] = family
    with pytest.raises(SystemExit, match="the families: cnn_bilstm"):
        manifest.family(cfg)
