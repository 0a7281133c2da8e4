"""BENCHMARK.json and the files it names, found by name.

A cell `<config>.<mix>` of `workloads` names a configuration
(configs/<config>.json), a traffic mix (traffic/<mix>.json) and its limits
(limits/<cell>.json); a per-layer metric is read by metrics/<name>.py.  A
later change adds a configuration, a mix or a metric by adding its file
and its entry, and edits none of these.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have: "
                     + ", ".join(w["name"] for w in bench["workloads"]) + ")")


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def config_file(name: str) -> Path:
    return HERE / "configs" / f"{name}.json"


def traffic_file(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def limits_file(cell: str) -> Path:
    return HERE / "limits" / f"{cell}.json"


def metric_file(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def config(name: str) -> dict:
    return _json(config_file(name))


def traffic(name: str) -> dict:
    return _json(traffic_file(name))


def limits(cell: str) -> dict:
    return _json(limits_file(cell))


def _reports(bench: dict, metric: dict, cell: str) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return any(m["name"] == metric.get("moves")
               and cell in m.get("workloads", [cell])
               for m in bench["end_to_end"])


def per_layer_for(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics a traced run of `cell` reports."""
    return [m for m in bench["per_layer"] if _reports(bench, m, cell)]
