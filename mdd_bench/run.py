"""The benchmark's command: one run of one cell of BENCHMARK.json.

  python3 -m mdd_bench.run --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

Prints one JSON object as the last line of standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `checks`, each compared number beside its limit (also the last lines
on standard error).  It measures `mdd_tpu_torch` on CUDA cards only: with
no card, or fewer than the cell asks for, it exits 1 and prints no result.
A cell on several cards starts a rank a card through the port's launcher
(mdd_tpu_torch/parallel/launch.py), rank 0 printing the line.

Every build and compile cache stays inside the checkout: the port builds
its kernels into mdd_tpu_torch/_build/; Python's bytecode,
TORCH_EXTENSIONS_DIR and TRITON_CACHE_DIR go under mdd_bench/_cache/.  The corpus is written
under TMPDIR and removed once the program has read it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

from mdd_bench import manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "mdd_tpu")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def _finite(obj):
    """JSON's numbers: a non-finite float becomes null."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m mdd_bench.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs() -> None:
    """Every cache under mdd_bench/_cache/, set before torch is imported.
    Python's bytecode of the program and of torch is cached there too
    (also where the environment turns bytecode writing off): where
    site-packages holds none, every run would compile ~1,000 of torch's
    modules again, ~10 s of set-up."""
    cache = manifest.HERE / "_cache"
    sys.pycache_prefix = str(cache / "pycache")
    sys.dont_write_bytecode = False
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def emit(result: dict) -> int:
    """Print the checks and the result line; -> the exit code."""
    found = forbidden_modules()
    if found:
        print("refused: loaded " + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in result.get("checks", {}).items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(_finite(result)), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs()
    bench = manifest.load()
    work = manifest.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the port on a card",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < work["chips"]:
        print(f"{work['name']} needs {work['chips']} cards, this host has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    from mdd_tpu_torch.parallel import launch, mesh

    if work["chips"] > 1 and not mesh.launched_locally():
        # the port's launcher, running this module as each rank
        launch.RANK_ENTRY = (sys.executable, "-m", "mdd_bench.run")
        return launch.launch_local(sys.argv[1:], work["chips"], "cuda")
    from mdd_bench import harness

    if mesh.launched_locally():
        launch.follow_launcher()
        with mesh.joined("cuda") as dev:
            result = harness.run_cell(args.workload, args.seed, args.seconds,
                                      bool(args.trace), str(dev), bench)
            if mesh.process_index() != 0:
                return 0
    else:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), "cuda", bench)
    return emit(result)


if __name__ == "__main__":
    sys.exit(main())
