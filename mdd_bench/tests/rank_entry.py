"""One gloo rank of a cell at the tests' small size: argv is the fault to
plant ("" for none), a file for rank 0's result, and how many times
faster rank 1's clock runs (the ranks then reach the window's deadline at
different steps)."""

import contextlib
import json
import sys
import time
import types

from mdd_tpu_torch.parallel import mesh

from mdd_bench import faults, harness
from mdd_bench.tests import small
from mdd_bench.tests.test_bench_faults import LIMITS


def main(fault: str, out: str, speed: float) -> None:
    with mesh.joined("cpu"):
        if mesh.process_index() == 1 and speed != 1.0:
            t0 = time.perf_counter()
            harness.time = types.SimpleNamespace(
                time=time.time,
                perf_counter=lambda: t0 + speed * (time.perf_counter() - t0))
        ctx = faults.planted(fault) if fault else contextlib.nullcontext()
        with ctx:
            res = harness.run_cell(
                small.CELL, 77, 0.5, False, device="cpu",
                cfg_override=small.CFG, mix_override=small.DP_MIX,
                limits=LIMITS)
        if mesh.process_index() == 0:
            with open(out, "w") as f:
                json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], float(sys.argv[3]))
