"""A cell's run in two gloo ranks on the CPU, as the port's launcher
starts them (torchrun's variables and the local mesh's mark): the sound
program is correct, also when the ranks' hosts reach the window's
deadline at different steps; with the exchange of gradients between the
ranks left out it is not."""

import json
import os
import socket
import subprocess
import sys



ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(fault: str, tmp_path, n: int = 2, speed: float = 1.0) -> dict:
    out = tmp_path / "result.json"
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   MDD_LOCAL_MESH=str(os.getpid()), OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT, TMPDIR=str(tmp_path))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mdd_bench.tests.rank_entry", fault,
             str(out), str(speed)], env=env, cwd=ROOT))
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0] * n
    return json.loads(out.read_text())


def test_two_ranks_are_correct(tmp_path):
    res = _run("", tmp_path)
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 2


def test_ranks_stop_together_when_their_clocks_disagree(tmp_path):
    # rank 1's clock runs 50 times as fast: it sees the deadline pass
    # after ~10 ms, rank 0 after half a second
    res = _run("", tmp_path, speed=50.0)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0


def test_the_exchange_left_out_is_not_correct(tmp_path):
    res = _run("exchange_left_out", tmp_path)
    assert not res["correct"]
    failed = {k for k, c in res["checks"].items()
              if not c["value"] <= c["limit"]}
    assert "grad_gap" in failed, res["checks"]
