"""Training loop (counterpart of mdd_tpu/train/loop.py).

The reference recipe (train_ctc.py): CTCLoss(sum) / true batch size, Adam
with coupled L2 weight decay over every parameter, greedy train-WER each
step, and the plateau learning-rate machine with best-state snapshot and
restore (train_ctc.py:215-268), with `best` and a resumable `latest`
(the model, the optimizer and, unlike mdd_tpu's, the plateau machine's two
snapshots, so a resumed run restores what an uninterrupted one would).
A run resumed from mdd_tpu's orbax `latest` (optax's Adam state mapped
to torch's, convert.py) goes on writing its `latest` and `best` in that
format, so that the run's files stay what its meta describes and mdd_tpu
can take the run back; any other run writes the port's `.pt`.
A float32 trainer on a card runs strict float32 (utils/precision.py).
A step is forward (the acoustic recurrence on the hand-written LSTM
kernels when the config asks for them), CTC loss, backward, Adam update
and the WER counts, all on the device; the metrics accumulate in a
device tensor that the host reads at print boundaries only.  A batch of
the device-resident corpus (data/device_cache.py) is gathered from the
corpus tensor and masked on the device before the same step.

Data parallel (a process group of N ranks, parallel/mesh.py), mdd_tpu's
one program over the global batch: every rank holds the same parameters
and takes its slice of each global batch.  Its loss is its rows' masked
nll sum over the global row count, BatchNorm's statistics span the global
batch (models/ctc_model.batch_stats), so the rank's gradient is a partial
sum of the global loss's and the ranks' gradients are summed, in one
all-reduce over a flat buffer, before the identical Adam step on each.
The metric accumulator is summed over the ranks when it is read, so every
rank logs the same numbers and the plateau machine decides alike.  Rank 0
writes the checkpoints.  On one host's local mesh (parallel/launch.py) a
global batch holds the config's batch_size rows, each rank ceil(B / N)
of its slots, the slots past the batch masked out of the loss count, the
statistics and the WER as a ragged tail's padding is.  Dropout masks differ by rank (the rank is folded
into their seed); the weight noise is drawn alike on every rank.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import threading
import time
import warnings
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from mdd_tpu_torch.data.dataset import Batch, pad_batch_to
from mdd_tpu_torch.data.device_cache import CachedBatch, to_device
from mdd_tpu_torch.frontend.augment import apply_spec_augment_masks
from mdd_tpu_torch.frontend.splice import batched_splice_skip
from mdd_tpu_torch.models.ctc_model import CTCAttentionModel, ModelConfig
from mdd_tpu_torch.ops.ctc_loss import ctc_loss
from mdd_tpu_torch.ops.wer_cuda import greedy_wer
from mdd_tpu_torch.parallel import mesh
from mdd_tpu_torch.train.checkpoint import (checkpoint_format,
                                            load_checkpoint,
                                            load_optimizer_state,
                                            load_snapshots, save_checkpoint)
from mdd_tpu_torch.train.plateau import PlateauAction, PlateauScheduler
from mdd_tpu_torch.utils import trace
from mdd_tpu_torch.utils.precision import strict_float32, tf32_flags


RANK_SEED_STRIDE = 0x9E3779B1   # odd, so ranks' dropout seeds never meet


def exact_output_sizes(model_frames, out_len: int, total_frames: int):
    """Per-item model-output frame counts, exact for any padded width:
    floor(m * out_len / T) in integers (mdd_tpu's loop.py:43-54)."""
    return (model_frames * out_len) // total_frames


def make_optimizer(params, lr: float, weight_decay: float):
    """Adam with coupled L2 weight decay (mdd_tpu's `make_optimizer`, the
    reference's torch.optim.Adam(weight_decay=..), train_ctc.py:187):
    torch's Adam adds wd * param to the gradient before the moments, as
    mdd_tpu's add_decayed_weights -> scale_by_adam does."""
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)


class Trainer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        init_lr: float = 1e-3,
        weight_decay: float = 5e-4,
        lr_decay: float = 0.5,
        end_adjust_acc: float = 2.0,
        plateau_patience: int = 10,
        max_adjust_times: int = 8,
        seed: int = 1234,
        device: str = "cuda",
        device_frontend: bool = False,
        left_ctx: int = 0,
        right_ctx: int = 2,
        n_skip_frame: int = 2,
        n_downsample: int = 2,
        weight_noise_std: float = 0.0,
    ):
        """weight_noise_std > 0: add_weight_noise at the start of every
        epoch."""
        # device_frontend: batches arrive as RAW (B, T_raw, D) features and
        # are spliced and frame-skipped on the device in the step; their
        # input_fracs carry raw-length fractions
        self.device = torch.device(device)
        self.device_frontend = device_frontend
        self.left_ctx, self.right_ctx = left_ctx, right_ctx
        self.n_skip_frame, self.n_downsample = n_skip_frame, n_downsample
        self.model_cfg = model_cfg
        ctx = left_ctx + 1 + right_ctx
        if device_frontend and model_cfg.input_dim % ctx:
            raise ValueError(f"input_dim {model_cfg.input_dim} is not "
                             f"divisible by the splice context {ctx}")
        self.rank, self.world = mesh.process_index(), mesh.process_count()
        self.weight_noise_std = weight_noise_std
        strict_float32(self.device, model_cfg.compute_dtype)
        self.model = CTCAttentionModel(model_cfg)
        self.model.init_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        mesh.broadcast_module(self.model)
        self.optimizer = make_optimizer(self.model.parameters(), init_lr,
                                        weight_decay)
        self.scheduler = PlateauScheduler(
            init_lr=init_lr, decay=lr_decay, end_adjust_acc=end_adjust_acc,
            patience=plateau_patience, max_adjust_times=max_adjust_times)
        # the dropout masks' stream, another on each rank (rank 0's is the
        # one-process stream; the CPU generator keeps a seed's low 32
        # bits, so the rank moves those); the weight noise's, alike on
        # every rank
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(
            (seed + 1 + self.rank * RANK_SEED_STRIDE) % 2 ** 32)
        self.noise_generator = torch.Generator(device=self.device)
        self.noise_generator.manual_seed(seed + 2)
        self._save_thread = None   # an asynchronous save in flight
        # the format the checkpoints are written in: the port's, or
        # mdd_tpu's where the run was restored from an orbax `latest`
        self.checkpoint_kind = "torch"
        self._snapshot = None      # plateau restore point
        self._best_acc_state = None
        self.loss_results: list = []
        self.dev_loss_results: list = []
        self.dev_acc_results: list = []

    # ------------------------------------------------------------------
    def _loss_and_out(self, arrays, train: bool):
        """-> (loss, wer errors, wer tokens), device scalars.  `mask` marks
        real rows; False rows (a ragged tail padded to the batch size) are
        left out of the batch statistics, the loss and the WER."""
        inputs, fracs, targets, tsizes, trans, trsizes, mask = arrays
        model_frames = None
        with trace.span("step.forward"):
            if self.device_frontend:
                raw_len = torch.round(fracs * inputs.shape[1]).long()
                inputs, model_frames = batched_splice_skip(
                    inputs, raw_len, self.left_ctx, self.right_ctx,
                    self.n_skip_frame, self.n_downsample)
            if inputs.shape[-1] != self.model_cfg.input_dim:
                raise ValueError(
                    f"spliced feature dim {inputs.shape[-1]} != model "
                    f"input_dim {self.model_cfg.input_dim}: the splice "
                    "geometry (left_ctx/right_ctx) disagrees between "
                    "loader and Trainer")
            log_probs = self.model(inputs, trans, trsizes, train=train,
                                   sample_mask=mask,
                                   generator=self.generator if train
                                   else None)
        with trace.span("step.loss"):
            out_len = log_probs.shape[0]
            if model_frames is not None:
                input_sizes = exact_output_sizes(model_frames, out_len,
                                                 inputs.shape[1])
            else:
                # host-spliced path: floor(frac * out_len), the
                # reference's length bookkeeping (train_ctc.py:68)
                input_sizes = (fracs * out_len).long()
            nll = ctc_loss(log_probs, input_sizes, targets, tsizes)
            maskf = mask.to(nll.dtype)
            # CTCLoss(sum) / true batch size — reference
            # train_ctc.py:72-74 — over the global batch: this rank's
            # share of the global loss
            count = mesh.all_reduce_sum(maskf.sum().detach())
            loss = (nll * maskf).sum() / count.clamp_min(1.0)
            ids = log_probs.detach().argmax(dim=-1).transpose(0, 1)
            errs, tokens = greedy_wer(ids, input_sizes, targets, tsizes,
                                      mask)
        return loss, errs, tokens

    @staticmethod
    def _acc_update(acc, loss, errs, tokens):
        # device-resident metric accumulator (4,) float32:
        # [loss_sum, wer_errors, wer_tokens, n_batches]
        return acc + torch.stack([loss.detach().float(), errs.float(),
                                  tokens.float(), torch.ones_like(acc[0])])

    def train_step(self, arrays, acc: torch.Tensor) -> torch.Tensor:
        """One optimizer step on a batch from `batch_arrays`; returns the
        updated metric accumulator."""
        with trace.span(trace.STEP):
            with trace.span("step.optimizer"):
                self.optimizer.zero_grad(set_to_none=True)
            loss, errs, tokens = self._loss_and_out(arrays, train=True)
            with trace.span("step.backward"):
                loss.backward()
                self.all_reduce_gradients()
            with trace.span("step.optimizer"):
                self.optimizer.step()
                return self._acc_update(acc, loss, errs, tokens)

    def all_reduce_gradients(self) -> None:
        """Sum the ranks' parameter gradients (each is a partial sum of
        the global loss's gradient); nothing in one process."""
        if self.world == 1:
            return
        params = list(self.model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        mesh.all_reduce_tensors([p.grad for p in params])

    @torch.no_grad()
    def eval_step(self, arrays, acc: torch.Tensor) -> torch.Tensor:
        return self._acc_update(acc, *self._loss_and_out(arrays, train=False))

    def batch_arrays(self, batch: Batch, valid: Optional[np.ndarray] = None):
        """The batch's arrays as tensors on the trainer's device: (inputs,
        fracs, targets, target sizes, trans, trans sizes, valid)."""
        if valid is None:
            valid = np.ones(batch.size, bool)
        put = lambda a: to_device(a, self.device)
        with trace.span("data.gather"):
            return (put(batch.inputs), put(batch.input_fracs),
                    put(batch.targets).long(), put(batch.target_sizes).long(),
                    put(batch.trans).long(), put(batch.trans_sizes).long(),
                    put(np.asarray(valid, bool)))

    def cached_arrays(self, cache, batch: CachedBatch):
        """The arrays of `batch_arrays` for a batch of the device-resident
        corpus `cache`: its rows gathered there, then SpecAugment's masks,
        then fracs = lengths / T_bucket (mdd_tpu's `_make_cached_step`)."""
        if not self.device_frontend:
            raise ValueError("the device cache holds raw features; build "
                             "the Trainer with device_frontend=True")
        put = lambda a: to_device(a, self.device)
        with trace.span("data.gather"):
            inputs, fracs = cache.gather(batch)
            return (apply_spec_augment_masks(inputs, put(batch.aug)), fracs,
                    put(batch.targets).long(), put(batch.target_sizes).long(),
                    put(batch.trans).long(), put(batch.trans_sizes).long(),
                    put(batch.valid))

    def _fetch(self, acc: torch.Tensor):
        """-> (mean loss, WER, batches) of the accumulator: the loss
        shares and WER counts summed over the ranks."""
        with trace.span("loop.fetch"):
            vals = acc.detach().to("cpu", copy=True).numpy()   # not a view
            vals[:3] = mesh.all_reduce_metrics(vals[:3])
        loss_sum, errs, tokens, n_b = (float(v) for v in vals)
        return loss_sum / max(1.0, n_b), errs / max(1.0, tokens), n_b

    def run_epoch(
        self,
        loader: Iterable[Batch],
        epoch: int,
        train: bool,
        print_every: int = 50,
        log=print,
    ) -> Tuple[float, float]:
        """-> (acc = 1 - WER, mean loss) — reference run_epoch contract.

        Ragged tails are padded to the loader's batch size, so every step
        runs at one batch size; the metrics are read from the device once
        per print_every steps and once at the end.  CachedBatches (of a
        CachedLoader, which pads them itself) are gathered from the
        loader's device-resident corpus."""
        full_b = getattr(loader, "batch_size", None)
        cache = getattr(loader, "cache", None)
        if (self.world > 1 and cache is None
                and not getattr(loader, "shape_coordinated", False)):
            # mdd_tpu warns alike; a list of batches the caller cut is fine
            warnings.warn(
                "a multi-process epoch over a loader without the global "
                "schedule: per-rank shards can differ in steps or shapes "
                "and deadlock the collectives")
        with trace.span("loop.epoch"):
            acc = torch.zeros(4, dtype=torch.float32, device=self.device)
            for i, batch in enumerate(loader):
                if isinstance(batch, CachedBatch):
                    arrays = self.cached_arrays(cache, batch)
                else:
                    target_b = (full_b if full_b and batch.size <= full_b
                                else batch.size)
                    padded, valid = pad_batch_to(batch, target_b)
                    if padded.score_mask is not None:
                        # rows run for equal shapes (tail padding, wrap-around
                        # duplicates) count nowhere
                        valid = valid & padded.score_mask
                    arrays = self.batch_arrays(padded, valid)
                if train:
                    acc = self.train_step(arrays, acc)
                else:
                    acc = self.eval_step(arrays, acc)
                if train and (i + 1) % print_every == 0:
                    avg, wer, _ = self._fetch(acc)
                    log("Epoch = %d, step = %d, total_loss = %.4f, "
                        "total_wer = %.4f" % (epoch, i + 1, avg, wer))
            avg_loss, wer, _ = self._fetch(acc)
            log("Epoch %d %s done, total_loss: %.4f, total_wer: %.4f"
                % (epoch, "Train" if train else "Valid", avg_loss, wer))
            return 1.0 - wer, avg_loss

    # ------------------------------------------------------------------
    def _device_snapshot(self):
        """A copy of the model and optimizer state in fresh device
        buffers (the plateau machine's restore point)."""
        return ({k: v.detach().clone()
                 for k, v in self.model.state_dict().items()},
                copy.deepcopy(self.optimizer.state_dict()))

    def _restore_snapshot(self, snap) -> None:
        """Install a snapshot by copy: the plateau machine may restore the
        same snapshot several times (train_ctc.py:258-265), and the
        optimizer would otherwise update the snapshot's own tensors.  So
        nothing ever writes to a snapshot's tensors once it is taken."""
        model_state, opt_state = snap
        self.model.load_state_dict(model_state)
        self.optimizer.load_state_dict(copy.deepcopy(opt_state))

    def _to_device(self, snap):
        """A snapshot read from disk, placed as _device_snapshot places
        one: its tensors on the trainer's device, but Adam's `step`
        counters on the CPU, where the optimizer keeps them."""
        if snap is None:
            return None
        model_state, opt_state = snap
        for per_param in opt_state["state"].values():
            for k, v in per_param.items():
                if k != "step" and isinstance(v, torch.Tensor):
                    per_param[k] = v.to(self.device)
        return ({k: v.to(self.device) for k, v in model_state.items()},
                opt_state)

    def _set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    @torch.no_grad()
    def add_weight_noise(self, std: float = 0.075) -> None:
        """Add N(0, std) noise to every parameter (the reference's
        `add_weights_noise`, model_ctc.py:246-249, which no trainer there
        calls; here every epoch with `weight_noise_std`).  The draws come
        from a generator seeded alike on every rank, so the replicas stay
        equal."""
        for p in self.model.parameters():
            p.add_(std * torch.randn(p.shape, generator=self.noise_generator,
                                     device=p.device, dtype=p.dtype))

    def fit(
        self,
        train_loader,
        dev_loader,
        num_epochs: int = 500,
        print_every: int = 50,
        checkpoint_dir: Optional[str] = None,
        exp_name: str = "default",
        log=print,
        resume: bool = False,
        checkpoint_every: int = 5,
    ) -> Dict[str, Any]:
        """checkpoint_every: save the resumable 'latest' checkpoint every
        N epochs, and always on the final epoch."""
        sched = self.scheduler
        epoch = 0
        log(f"compute_dtype {self.model_cfg.compute_dtype} on "
            f"{self.device.type}: {tf32_flags()}")
        if resume and checkpoint_dir and checkpoint_format(
                os.path.join(checkpoint_dir, exp_name), "latest"):
            epoch = self.restore(checkpoint_dir, exp_name, "latest", log)
            # continue the loaders' augmentation / shuffle sequence
            for ld in (train_loader, dev_loader):
                set_ep = getattr(ld, "set_epoch", None)
                if set_ep is not None:
                    set_ep(epoch)
            read = {"torch": "the port's latest.pt",
                    "orbax": "mdd_tpu's orbax latest/"}[self.checkpoint_kind]
            log(f"resumed from epoch {epoch} "
                f"(lr {sched.learning_rate:.5f}) of {read}")
        start = time.time()
        while not sched.stopped and epoch < num_epochs:
            epoch += 1
            self._set_lr(sched.learning_rate)
            if self.weight_noise_std > 0:
                self.add_weight_noise(self.weight_noise_std)
            log("Start training epoch: %d, learning_rate: %.5f"
                % (epoch, sched.learning_rate))
            _, train_loss = self.run_epoch(train_loader, epoch, True,
                                           print_every, log)
            acc, dev_loss = self.run_epoch(dev_loader, epoch, False,
                                           print_every, log)
            self.loss_results.append(train_loss)
            self.dev_loss_results.append(dev_loss)
            self.dev_acc_results.append(acc)

            action = sched.step(dev_loss, acc)
            if action & PlateauAction.SNAPSHOT_LOSS:
                self._snapshot = self._device_snapshot()
            if action & PlateauAction.SNAPSHOT_ACC:
                self._best_acc_state = self._device_snapshot()
            if (action & PlateauAction.DECAY_AND_RESTORE
                    and self._snapshot is not None):
                self._restore_snapshot(self._snapshot)
            log("adjust_rate_count:%d adjust_time:%d"
                % (sched.adjust_rate_count, sched.adjust_time))
            log("epoch %d done, cv acc is: %.4f, time_used: %.4f minutes"
                % (epoch, acc, (time.time() - start) / 60))
            done = sched.stopped or epoch >= num_epochs
            if checkpoint_dir and (epoch % max(checkpoint_every, 1) == 0
                                   or done):
                # written while the next epochs train
                self.save_async(checkpoint_dir, exp_name, "latest", epoch)

        log("End training, best dev loss is: %.4f, acc is: %.4f"
            % (sched.loss_best, sched.acc_best))
        self.join_saves()           # the final 'latest' must be durable
        if self._best_acc_state is not None:
            self._restore_snapshot(self._best_acc_state)
        if checkpoint_dir:
            self.save(checkpoint_dir, exp_name, "best", epoch)
        return {"loss_results": self.loss_results,
                "dev_loss_results": self.dev_loss_results,
                "dev_acc_results": self.dev_acc_results,
                "best_dev_loss": sched.loss_best,
                "best_acc": sched.acc_best,
                "epochs": epoch}

    def _save_meta(self, epoch: int) -> Dict[str, Any]:
        return {
            "model_config": dataclasses.asdict(self.model_cfg),
            "epoch": epoch,
            "loss_results": list(self.loss_results),
            "dev_loss_results": list(self.dev_loss_results),
            "dev_acc_results": list(self.dev_acc_results),
            "learning_rate": self.scheduler.learning_rate,
            "scheduler": dataclasses.asdict(self.scheduler),
        }

    def _snapshots(self, epoch: int) -> Dict[str, Any]:
        """The plateau machine's two snapshots, as `latest` carries them."""
        return {"epoch": epoch, "snapshot": self._snapshot,
                "best_acc_state": self._best_acc_state}

    def save(self, directory: str, exp_name: str, tag: str,
             epoch: int) -> str:
        """Synchronous save (rank 0 writes; the others only wait for an
        earlier save) in the run's format; `latest` carries the optimizer
        state and the plateau snapshots."""
        self.join_saves()
        path = os.path.join(directory, exp_name)
        if self.rank == 0:
            latest = tag == "latest"
            save_checkpoint(
                path, tag, self.model.state_dict(), self._save_meta(epoch),
                optimizer_state=(self.optimizer.state_dict() if latest
                                 else None),
                snapshots=self._snapshots(epoch) if latest else None,
                kind=self.checkpoint_kind, model=self.model)
        return path

    def save_async(self, directory: str, exp_name: str, tag: str,
                   epoch: int) -> None:
        """Save off the training path: a device copy of the state is taken
        now, and a thread moves it to the host and writes it while
        training goes on.  At most one save is in flight; the meta is
        taken now too.  Rank 0 only."""
        self.join_saves()
        if self.rank != 0:
            return
        model_state, opt_state = self._device_snapshot()
        meta = self._save_meta(epoch)
        path = os.path.join(directory, exp_name)
        latest = tag == "latest"
        # the snapshots go to the thread uncloned: nothing writes to a
        # snapshot's tensors (_restore_snapshot installs by copy), and a
        # new snapshot replaces the pair, not its tensors.  The model is
        # read for its parameters' names only
        self._save_thread = threading.Thread(
            target=save_checkpoint, daemon=True,
            args=(path, tag, model_state, meta,
                  opt_state if latest else None,
                  self._snapshots(epoch) if latest else None,
                  self.checkpoint_kind, self.model))
        self._save_thread.start()

    def join_saves(self) -> None:
        """Block until an asynchronous save has written its files."""
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None

    def restore(self, directory: str, exp_name: str,
                tag: str = "latest", log=print) -> int:
        """Load params, BN statistics, the optimizer state and the plateau
        snapshots (`latest`), the scheduler and the loss histories, from
        the port's files or mdd_tpu's orbax ones, whose format the later
        saves then keep; -> the epoch to continue from.  Every rank reads
        the same files.  A checkpoint that cannot be read or mapped
        raises: nothing starts afresh."""
        path = os.path.join(directory, exp_name)
        kind = checkpoint_format(path, tag)
        state, meta = load_checkpoint(path, tag)
        epoch = int(meta.get("epoch", 0))
        self.model.load_state_dict(state)
        mesh.broadcast_module(self.model)     # rank 0's weights everywhere
        if tag == "latest":
            self.optimizer.load_state_dict(load_optimizer_state(
                path, tag, self.model,
                self.optimizer.param_groups[0]["weight_decay"]))
            snaps = load_snapshots(path, tag)
            if snaps is None or snaps.get("epoch") != epoch:
                # mdd_tpu writes no snapshot file, and leaves the port's
                # of an older epoch behind when it saves in this directory
                log(f"{tag} has no plateau snapshots of its epoch {epoch} "
                    "(written before they were saved, or by mdd_tpu): no "
                    "halving restores a state until the dev loss improves "
                    "again")
            else:
                self._snapshot = self._to_device(snaps["snapshot"])
                self._best_acc_state = self._to_device(
                    snaps["best_acc_state"])
        for k, v in meta.get("scheduler", {}).items():
            if hasattr(self.scheduler, k):
                setattr(self.scheduler, k, v)
        # the group's rate is the scheduler's, as fit sets it every epoch
        # (optax keeps it in float32)
        self._set_lr(self.scheduler.learning_rate)
        self.loss_results = list(meta.get("loss_results", []))
        self.dev_loss_results = list(meta.get("dev_loss_results", []))
        self.dev_acc_results = list(meta.get("dev_acc_results", []))
        self.checkpoint_kind = kind
        return epoch
