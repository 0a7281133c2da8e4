"""Sustained-load measurement of the socket serving path (counterpart of
tools/serve_loadtest.py).

Starts the port's `SocketServer` on an ephemeral loopback TCP port, drives
it with N concurrent clients for a fixed time, each sending one request
and waiting for its answer before the next, and prints one JSON line:
requests answered, errors, requests per second and the p50 / p90 / p99 /
max latency a client saw.  The wavs are seeded ones the tool writes
itself (0.6-3.2 s of tones in noise); each request names one of them and
a prompt word that the dictionary of `--dict-dir` holds.

  python -m mdd_tpu_torch.tools.serve_loadtest --conf C --checkpoint D \\
      --cmvn F --dict-dir X --words about gather --clients 4 --seconds 15 \\
      [--warmup] [--no-denoise] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from mdd_tpu_torch.frontend.wav import write_wav


def write_wavs(out_dir: str, n: int = 8, seed: int = 0,
               seconds: Tuple[float, float] = (0.6, 3.2)) -> List[str]:
    """n seeded 16 kHz wavs from seconds[0] to seconds[1] long: three tones
    under a Hann envelope in white noise."""
    rng = np.random.default_rng(seed)
    paths = []
    for i, secs in enumerate(np.linspace(seconds[0], seconds[1], n)):
        k = int(secs * 16000)
        t = np.arange(k) / 16000.0
        sig = sum(a * np.sin(2 * np.pi * f * t) for a, f in
                  zip(rng.uniform(500, 4000, 3), rng.uniform(100, 3000, 3)))
        sig = sig * np.hanning(k) + 300 * rng.standard_normal(k)
        path = str(Path(out_dir) / f"load{i}.wav")
        write_wav(path, sig.astype(np.float32), 16000)
        paths.append(path)
    return paths


def _client(port: int, requests: Sequence[Tuple[str, str]], deadline: float,
            seed: int, latencies: list, errors: list) -> None:
    rng = np.random.default_rng(seed)
    with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
        f = s.makefile("rw", encoding="utf-8")
        i = 0
        while time.perf_counter() < deadline:
            wav, word = requests[int(rng.integers(len(requests)))]
            t0 = time.perf_counter()
            f.write(json.dumps({"id": f"{seed}_{i}", "wav": wav,
                                "word": word}) + "\n")
            f.flush()
            line = f.readline()
            dt = time.perf_counter() - t0
            resp = json.loads(line) if line else {"error": "closed"}
            if resp.get("status") == "ok":
                latencies.append(dt)
            else:
                errors.append(resp.get("error", "?"))
                if not line:
                    return
            i += 1


def run_loadtest(engine, requests: Sequence[Tuple[str, str]], clients: int,
                 seconds: float, max_batch: int = 16) -> dict:
    """`clients` concurrent clients for `seconds` against a SocketServer on
    `engine`; requests are (wav path, word) pairs drawn at random."""
    from mdd_tpu_torch.serve import SocketServer

    server = SocketServer(engine, "127.0.0.1:0", max_batch=max_batch)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    latencies: list = []
    errors: list = []
    forwards = engine.session.forwards
    t_start = time.perf_counter()
    threads = [threading.Thread(
        target=_client, args=(server.port, requests, t_start + seconds,
                              100 + c, latencies, errors), daemon=True)
        for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + 300)
    wall = time.perf_counter() - t_start
    server.shutdown()
    serving.join(timeout=30)
    if serving.is_alive() or any(t.is_alive() for t in threads):
        raise RuntimeError("the load test did not end")
    lat = np.asarray(latencies)
    pct = (lambda q: 1e3 * float(np.percentile(lat, q))) if lat.size else (
        lambda q: float("nan"))
    return {
        "clients": clients,
        "seconds": wall,
        "requests_ok": int(lat.size),
        "errors": len(errors),
        "sample_errors": errors[:3],
        "requests_per_s": lat.size / wall,
        "p50_ms": pct(50), "p90_ms": pct(90), "p99_ms": pct(99),
        "max_ms": 1e3 * float(lat.max()) if lat.size else float("nan"),
        "forwards": engine.session.forwards - forwards,
    }


def main(argv=None) -> int:
    from mdd_tpu_torch import cli

    ap = argparse.ArgumentParser(prog="serve_loadtest")
    ap.add_argument("--conf", required=True)
    ap.add_argument("--checkpoint")
    ap.add_argument("--cmvn", required=True)
    ap.add_argument("--dict-dir")
    ap.add_argument("--ecdict-csv")
    ap.add_argument("--words", nargs="+", default=["about"],
                    help="prompt words the dictionary holds")
    ap.add_argument("--wavs", type=int, default=8,
                    help="seeded wavs to write (0.6-3.2 s)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--warmup", action="store_true",
                    help="run the serving shape set first")
    ap.add_argument("--denoise", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    engine = cli._build_engine(argparse.Namespace(
        conf=args.conf, checkpoint=args.checkpoint, cmvn=args.cmvn,
        dict_dir=args.dict_dir, ecdict_csv=args.ecdict_csv,
        denoise=args.denoise, forgiving=None, phonetic_format="cmu",
        decode_type=None, device=args.device))
    if args.warmup:
        engine.warmup(max_seconds=3.2)
    with tempfile.TemporaryDirectory() as d:
        paths = write_wavs(d, args.wavs, args.seed)
        requests = [(p, args.words[i % len(args.words)])
                    for i, p in enumerate(paths)]
        out = run_loadtest(engine, requests, args.clients, args.seconds,
                           args.max_batch)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
