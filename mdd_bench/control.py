"""Readings for the limits of `correct`: the program's comparison numbers
over many seeds, and the control's.

  python3 -m mdd_bench.control --workload <cell> --seeds 1 2 3 ... \\
      [--control-seeds 1 2 3] [--fault NAME --fault-seeds 1 2 3] \\
      [--out FILE]

For each of --seeds it runs the cell's set-up, whose first steps the
comparison judges, and a window of one step (harness.run_cell); for each
of --control-seeds it puts the reference computed in float8 (e4m3, a
scale a tensor) in the program's place, the precision below the
configuration's bfloat16, and judges it the same way; for each of
--fault-seeds it runs the program with the fault NAME planted (faults.py).
One JSON line a reading, with each step's two losses and the worst
leaves; the limits (limits/<cell>.json) are set from them by hand, above
the program's largest and below the control's smallest.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from mdd_bench import compare, corpus, faults, manifest, reference
from mdd_bench.weights import make_weights


def control_checks(cell: str, seed: int, device,
                   cfg_override=None, mix_override=None, limits=None,
                   precision: str = "fp8", detail=None) -> dict:
    """The comparison of the reference at `precision`, standing in for
    the program, against the float32 reference."""
    bench = manifest.load()
    work = manifest.workload(bench, cell)
    cfg = dict(manifest.config(work["config"]), **(cfg_override or {}))
    mix = dict(manifest.traffic(work["traffic"]), **(mix_override or {}))
    world = int(work["chips"])
    data = corpus.generate(mix, cfg["units"], seed, device)
    n = int(mix["correctness_steps"])
    batches = reference.first_batches(data, cfg, mix, seed, n)
    w0 = {k: v.cpu() for k, v in make_weights(cfg, seed, device).items()}
    ref = reference.run_steps(data, cfg, batches, w0, seed, device,
                              world=world)
    low = reference.run_steps(data, cfg, batches, w0, seed, device,
                              precision=precision, world=world)
    # judged as rank 0 is: its share of each global batch
    rows = slice(0, len(batches[0].items) // world)
    counts = [reference.greedy_wer(lp[:, rows], sz[rows], b.targets[rows],
                                   b.target_sizes[rows], b.valid[rows])
              for lp, sz, b in zip(low["log_probs"], low["input_sizes"],
                                   batches)]
    prog = {
        "arrays": [(x[rows], torch.as_tensor(b.lengths[rows]).float()
                    / b.bucket, torch.as_tensor(b.targets[rows]),
                    torch.as_tensor(b.target_sizes[rows]),
                    torch.as_tensor(b.trans[rows]),
                    torch.as_tensor(b.trans_sizes[rows]),
                    torch.as_tensor(b.valid[rows]))
                   for x, b in zip(low["inputs"], batches)],
        "log_probs": [lp[:, rows] for lp in low["log_probs"]],
        "loss": low["loss"],
        "errs": [c[0] for c in counts], "tokens": [c[1] for c in counts],
        "grad1": low["grad1"],
        "params": {k: w0[k] + low["delta"][k] for k in w0}, "rows": rows}
    return compare.judge(prog, ref, batches, w0,
                         limits or manifest.limits(cell), rows, detail)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mdd_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=faults.NAMES, default=None)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from mdd_tpu_torch.parallel import launch, mesh

    from mdd_bench import harness
    from mdd_bench.run import cache_dirs

    cache_dirs()
    chips = manifest.workload(manifest.load(), a.workload)["chips"]
    if chips > 1 and not mesh.launched_locally():
        launch.RANK_ENTRY = (sys.executable, "-m", "mdd_bench.control")
        return launch.launch_local(sys.argv[1:], chips, "cuda")
    if mesh.launched_locally():
        launch.follow_launcher()
        with mesh.joined("cuda"):
            readings(a, harness, mesh.process_index())
        return 0
    readings(a, harness, 0)
    return 0


def readings(a, harness, rank: int) -> None:
    """Every reading of `a`'s seeds; rank 0 writes them."""

    def program(seed, kind):
        detail = {}
        res = harness.run_cell(a.workload, seed, 0.0, False, "cuda",
                               mix_override={"warmup_epochs": 0},
                               detail=detail)
        if rank != 0:
            return None
        return {"kind": kind, "seed": seed, "correct": res["correct"],
                "checks": {k: c["value"] for k, c in res["checks"].items()},
                **detail}

    out = open(a.out, "a") if a.out and rank == 0 else sys.stdout

    def emit(line):
        if rank == 0:
            print(json.dumps(line), file=out, flush=True)

    try:
        for seed in a.seeds:
            emit(program(seed, "program"))
        for seed in a.fault_seeds:
            with faults.planted(a.fault):
                emit(program(seed, "fault_" + a.fault))
        for seed in a.control_seeds if rank == 0 else ():
            detail = {}
            checks = control_checks(a.workload, seed, "cuda", detail=detail)
            emit({"kind": "control_fp8", "seed": seed,
                  "checks": {k: c["value"] for k, c in checks.items()},
                  **detail})
    finally:
        if out is not sys.stdout:
            out.close()


if __name__ == "__main__":
    sys.exit(main())
