"""The hard-profile quality run of the port, end to end, on one GPU.

    python -m mdd_tpu_torch.tools.quality_run [--out DIR] [--kill-at 33]

From the repo root (the recipe's paths are relative to it):

1. the hard corpus, 5,496 / 897 / 900 utterances of 16-40 phones, into
   data/synthetic_full_hard/ with the port's corpus tool and the 41-unit
   inventory results/synthetic_full_hard_torch/units (`sil` first: the
   inventory that regenerates mdd_tpu's hard-recipe test split);
2. `train --conf conf/synthetic_full_hard.yaml` as written, killed
   (SIGKILL) when epoch `--kill-at` starts, then `train --resume` to the
   plateau machine's own stop;
3. `train-lm` on the training labels into the recipe's `lm_path`;
4. `evaluate` greedy, beam at --lm-alpha 0 and beam at the recipe's 0.5,
   each with --dump-dir;
5. in this process, from `latest`: one epoch of cached train steps at the
   recipe's B=256, each timed to a synchronize (median, audio seconds per
   second, peak device memory with the corpus on the device), then
   torch.profiler over 3 more (device busy share, top device consumers).

Everything goes to DIR (default runs/quality, gitignored) as it happens: the
logs of each step, each epoch's line with its wall time (epochs.jsonl)
and summary.json.  Each train and evaluate step runs as its own process,
as a user runs it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

CONF = "conf/synthetic_full_hard.yaml"
UNITS = "results/synthetic_full_hard_torch/units"
SIZES = (5496, 897, 900)
EPOCH_DONE = re.compile(r"epoch (\d+) done, cv acc is: (\S+),")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class Run:
    """Subprocesses of `python -m mdd_tpu_torch`, their logs in `out`."""

    def __init__(self, out: Path):
        self.out = out
        self.epochs = open(out / "epochs.jsonl", "a", encoding="utf-8")
        self.env = dict(os.environ, PYTHONUNBUFFERED="1")

    def cli(self, log: str, *args: str, kill_at: int = 0) -> dict:
        """Run one subcommand, its output line by line into `log`; a train
        run's epoch lines also go to epochs.jsonl with their wall time.
        With `kill_at`, SIGKILL it when that epoch starts."""
        cmd = [sys.executable, "-m", "mdd_tpu_torch", *args]
        t0 = time.perf_counter()
        last = t0
        killed = False
        with open(self.out / log, "w", encoding="utf-8") as f, \
                subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True,
                                 env=self.env) as proc:
            f.write("$ " + " ".join(cmd[1:]) + "\n")
            for line in proc.stdout:
                f.write(line)
                f.flush()
                now = time.perf_counter()
                m = EPOCH_DONE.search(line)
                if m:
                    self.epochs.write(json.dumps({
                        "log": log, "epoch": int(m.group(1)),
                        "dev_acc": float(m.group(2)),
                        "seconds": now - last}) + "\n")
                    self.epochs.flush()
                    last = now
                if kill_at and line.startswith(
                        f"Start training epoch: {kill_at},"):
                    proc.send_signal(signal.SIGKILL)
                    killed = True
            rc = proc.wait()
            wall = time.perf_counter() - t0
            f.write(f"# exit {rc} after {wall:.1f} s\n")
        if rc != 0 and not killed:
            raise SystemExit(f"{' '.join(args)} exited {rc}; see {log}")
        return {"log": log, "rc": rc, "seconds": wall, "killed": killed}


def report(path: Path) -> dict:
    """The all-languages numbers of an `evaluate` log."""
    block = path.read_text().split(" mandarin ")[0]
    grab = lambda pat: re.search(pat, block).group(1)
    out = {"per": float(grab(r"Phoneme error rate on test set: (\S+)")),
           "errors": int(grab(r"total_error: (\d+)")),
           "tokens": int(grab(r"total_phoneme: (\d+)"))}
    for key in ("TA", "FR", "FA", "TR"):
        out[key] = int(grab(rf"{key} :  (\d+)"))
    for key in ("Precision", "Recall", "F1 score"):
        out[key.split()[0].lower()] = float(grab(rf"{key} : (\S+)"))
    return out


def measure() -> dict:
    """Cached train steps at the recipe's batch from `latest`: an epoch
    timed step by step, then 3 under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mdd_tpu_torch import cli
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.utils.config import load_config

    cfg = load_config(CONF)
    vocab = Vocab.from_units_file(cfg.vocab_file)
    torch.cuda.reset_peak_memory_stats()
    trainer = cli.build_trainer(cfg, vocab, "cuda")
    trainer.restore(cfg.checkpoint_dir, cfg.exp_name, "latest")
    loader = cli._build_loader(cfg, vocab, cfg.train_scp_path,
                               cfg.train_lab_path, cfg.train_trans_path,
                               train=True, device="cuda")
    cache = loader.cache
    acc = torch.zeros(4, device="cuda")
    secs, audio = [], []
    it = iter(loader)
    while True:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            break
        acc = trainer.train_step(trainer.cached_arrays(cache, batch), acc)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        audio.append(float(batch.lengths[batch.valid].sum()) * 0.01)
    peak = torch.cuda.max_memory_allocated()
    batches = list(loader)[:3]
    for _ in range(2):       # a window the profiler returned empty: again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for batch in batches:
                acc = trainer.train_step(
                    trainer.cached_arrays(cache, batch), acc)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = sorted((e for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
        busy_us = sum(e.self_device_time_total for e in events)
        if busy_us > 0:
            break
    return {
        "steps": len(secs), "step_median_ms": statistics.median(secs) * 1e3,
        "step_min_ms": min(secs) * 1e3, "step_max_ms": max(secs) * 1e3,
        "buckets": sorted(cache.buckets),
        "audio_s_per_s": sum(audio) / sum(secs),
        "train_audio_s": float(cache.lengths.sum()) * 0.01,
        "cache_bytes": cache.bytes, "peak_bytes": peak,
        "profiled_wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us,
        "device_ops": sum(e.count for e in events),
        "top": [{"name": e.key[:100], "ms": e.self_device_time_total / 1e3,
                 "count": e.count} for e in events[:12]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mdd_tpu_torch.tools.quality_run",
        description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="runs/quality")
    ap.add_argument("--kill-at", type=int, default=33,
                    help="SIGKILL the first train run when this epoch "
                         "starts (0: no kill)")
    a = ap.parse_args(argv)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    summary = {"card": card(), "conf": CONF}
    run = Run(out)
    from mdd_tpu_torch.utils.config import load_config

    cfg = load_config(CONF)
    data = Path(cfg.vocab_file).parent
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mdd_tpu_torch.tools.synthetic_corpus",
         str(data), *map(str, SIZES), "--profile", "hard", "--min-phones",
         "16", "--max-phones", "40", "--units", UNITS],
        capture_output=True, text=True, check=True)
    (out / "corpus.log").write_text(proc.stdout + proc.stderr)
    summary["corpus_seconds"] = time.perf_counter() - t0
    summary["train"] = [run.cli("train_run1.log", "train", "--conf", CONF,
                                kill_at=a.kill_at)]
    if summary["train"][0]["killed"]:
        summary["train"].append(run.cli("train_run2_resume.log", "train",
                                        "--conf", CONF, "--resume"))
    run.cli("train_lm.log", "train-lm", "--phn-text", cfg.train_lab_path,
            "--out", cfg.lm_path)
    summary["evaluate"] = {}
    for name, flags in (("greedy", ["--decode-type", "Greedy"]),
                        ("beam_lm0", ["--lm-alpha", "0"]),
                        ("beam_lm05", [])):
        log = f"eval_{name}.log"
        summary["evaluate"][name] = run.cli(
            log, "evaluate", "--conf", CONF, "--dump-dir",
            str(out / f"dump_{name}"), *flags)
        summary["evaluate"][name].update(report(out / log))
    meta = json.loads((Path(cfg.checkpoint_dir) / cfg.exp_name
                       / "best.meta.json").read_text())
    summary["epochs"] = meta["epoch"]
    summary["best_dev_acc"] = max(meta["dev_acc_results"])
    summary["best_dev_loss"] = min(meta["dev_loss_results"])
    summary["scheduler"] = meta["scheduler"]
    summary["measure"] = measure()
    summary["card_after"] = card()
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
