"""BENCHMARK.json and the files it names, found by name.

A cell `<config>.<mix>` of `workloads` names a configuration
(configs/<config>.json), a traffic mix (traffic/<mix>.json) and its limits
(limits/<cell>.json); a configuration names its model family
(families/<family>.py, whose interface families/__init__.py gives); a
per-layer metric is read by metrics/<name>.py.  A later change adds a
configuration, of a family there is or of a new one, a mix or a metric by
adding its files and its entries, and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

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


def family_file(name: str) -> Path:
    return HERE / "families" / f"{name}.py"


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


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file `path`, executed as a module called `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def families() -> List[str]:
    return sorted(p.stem for p in (HERE / "families").glob("*.py")
                  if p.stem != "__init__")


_FAMILY = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_-]*")
_loaded: Dict[Path, ModuleType] = {}


def family(cfg: dict) -> ModuleType:
    """The module of the configuration's `"family"`: families/<name>.py,
    loaded once (by its path) and kept."""
    name = cfg.get("family")
    path = family_file(name) if isinstance(name, str) else None
    if path in _loaded:
        return _loaded[path]
    if (path is None or not _FAMILY.fullmatch(name) or name == "__init__"
            or not path.is_file()):
        raise SystemExit(
            f"configuration {cfg.get('name')!r} names family {name!r}, "
            "which has no file families/<family>.py (the families: "
            + ", ".join(families()) + ")")
    _loaded[path] = load_module(path, "mdd_bench_family_" + name)
    return _loaded[path]
