"""A data-parallel run of the port's library surface, one process a rank
(counterpart of tools/distributed_smoke.py, with its steps, seeds and
result fields).

Each rank runs this module with torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT); without it, it runs as one
process, the ground truth that several ranks must reproduce:

  * `parallel.mesh.init_distributed` and the rank's device;
  * train steps of a small model where every rank contributes its rows of
    the same global batches (cross-rank BatchNorm statistics, loss over
    the global row count, gradients summed over the ranks);
  * an eval epoch whose loss and WER counts are summed over the ranks;
  * an MDD report summed over per-rank utterance shares
    (`evals.evaluate.all_reduce_report`);
  * a train epoch on the device-resident corpus, row-sharded over the
    ranks, through the CachedLoader's global schedule.

Usage (2 ranks, or `torchrun --nproc-per-node 2 -m ...`):
    RANK=0 WORLD_SIZE=2 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 \\
        python -m mdd_tpu_torch.tools.distributed_smoke --out p0.json &
    RANK=1 WORLD_SIZE=2 LOCAL_RANK=1 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 \\
        python -m mdd_tpu_torch.tools.distributed_smoke --out p1.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True, help="this rank's JSON result")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs under gloo)")
    args = p.parse_args(argv)
    from mdd_tpu_torch.parallel import mesh

    with (mesh.joined(args.device) if os.environ.get("WORLD_SIZE")
          else contextlib.nullcontext(args.device)) as device:
        run(args, device)
    return 0


def run(args, device) -> None:
    from mdd_tpu_torch.data.dataset import Batch, SpeechDataset
    from mdd_tpu_torch.data.device_cache import (CachedLoader,
                                                 DeviceFeatureCache)
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.evals.evaluate import (all_reduce_report,
                                              report_to_vector, score_mdd)
    from mdd_tpu_torch.frontend import kaldi_io
    from mdd_tpu_torch.models.ctc_model import ModelConfig
    from mdd_tpu_torch.parallel import mesh
    from mdd_tpu_torch.train.loop import Trainer

    pid, nproc = mesh.process_index(), mesh.process_count()
    quiet = lambda *_: None
    # dropout 0: each rank draws its own masks (mdd_tpu's span the
    # global batch), so only then can several ranks equal one
    cfg = ModelConfig(input_dim=24, num_class=12, rnn_hidden_size=16,
                      rnn_layers=1, text_embed_size=8, dropout=0.0)
    trainer = Trainer(cfg, seed=11, device=device)

    # the same GLOBAL batches on every rank, each taking its rows
    b_global, t, l = 8, 16, 4
    b_local = b_global // nproc
    lo, hi = pid * b_local, (pid + 1) * b_local
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(args.steps):
        inputs = rng.standard_normal((b_global, t, cfg.input_dim)
                                     ).astype(np.float32)
        targets = rng.integers(2, cfg.num_class, (b_global, l)
                               ).astype(np.int32)
        batches.append(Batch(
            inputs=inputs[lo:hi],
            input_fracs=np.full((b_local,), 1.0, np.float32),
            targets=targets[lo:hi],
            target_sizes=np.full((b_local,), l, np.int32),
            trans=targets[lo:hi].copy(),
            trans_sizes=np.full((b_local,), l, np.int32),
            utt_ids=[f"utt{i}" for i in range(lo, hi)]))

    train_losses = []
    for step_batch in batches:
        _, loss = trainer.run_epoch([step_batch], epoch=1, train=True,
                                    log=quiet)
        train_losses.append(float(loss))
    dev_acc, dev_loss = trainer.run_epoch(batches, epoch=1, train=False,
                                          log=quiet)

    # the global tallies are the sum of every rank's share
    utts = [(f"TXHC_u{i}" if i % 2 else f"ABA_u{i}",
             ["aa", "b", "k"], ["aa", "b"], ["aa", "b"])
            for i in range(6)]
    global_rep = all_reduce_report(score_mdd(utts[pid::nproc]))

    # the device-resident corpus, row-sharded over the ranks, and the
    # CachedLoader's global schedule with every rank's row slice
    with tempfile.TemporaryDirectory() as d:
        rng2 = np.random.default_rng(5)
        with kaldi_io.ArkScpWriter(f"{d}/f.ark", f"{d}/f.scp") as w, \
                open(f"{d}/lab", "w") as lab_f, \
                open(f"{d}/trn", "w") as trn_f:
            for i in range(10):
                nfrm = int(rng2.integers(16, 48))
                w.write(f"u{i}", rng2.standard_normal((nfrm, 8)).astype(
                    np.float32))
                lab_f.write(f"u{i} p2 p3 p4\n")
                trn_f.write(f"u{i} p2 p3 p4\n")
        vocab = Vocab([f"p{i}" for i in range(2, 10)])
        ds = SpeechDataset(vocab, f"{d}/f.scp", f"{d}/lab", f"{d}/trn",
                           train=True, device_frontend=True)
        cfg_dc = ModelConfig(input_dim=24, num_class=10,
                             rnn_hidden_size=16, rnn_layers=1,
                             text_embed_size=8, dropout=0.0)
        tr2 = Trainer(cfg_dc, seed=3, device=device,
                      device_frontend=True)
        ranks = dict(process_index=pid, process_count=nproc)
        cache = DeviceFeatureCache(ds, device, time_quantum=8,
                                   wire_dtype="float32", **ranks)
        cl = CachedLoader(cache, batch_size=8 // nproc, shuffle=True,
                          seed=2, **ranks)
        _, cached_loss = tr2.run_epoch(cl, epoch=1, train=True,
                                       log=quiet)

    with open(args.out, "w") as f:
        json.dump({
            "process_id": pid,
            "num_processes": nproc,
            "global_devices": nproc,
            "train_losses": train_losses,
            "dev_loss": float(dev_loss),
            "dev_acc": float(dev_acc),
            "report_vector": [int(v) for v in
                              report_to_vector(global_rep)],
            "cached_loss": float(cached_loss),
        }, f)
    print(f"[{pid}] distributed smoke OK: train_losses={train_losses}",
          flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
