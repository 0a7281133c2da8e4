"""Speech dataset, bucketed batching and the batch record (counterpart of
mdd_tpu/data/dataset.py, single process).

  * items join fbank scp + actual-phone labels + canonical transcripts
    (reference SpeechDataset.process_feature_label:79-121 semantics,
    including the `utt.split('.')[0]` scp-key normalization);
  * per-item transform: SpecAugment + canonical-transcript mutation when
    training, then context splice, frame skip and pad-to-multiple on the
    host, or none of the three with `device_frontend` (raw features on the
    wire, `frontend.splice.batched_splice_skip` in the training step);
  * batches are zero-padded and bucketed by padded length, each item's
    augmentation drawn from its own Generator keyed (seed + epoch, index),
    so the batches equal mdd_tpu's bit for bit at the same seed.

Batch layout mirrors the reference collate (create_input:151-181), with
input sizes stored as fractions of the padded length: the consumer
multiplies them by the model's output frame count (train_ctc.py:68).

Several processes: each rank iterates either its own equal-length share
of the corpus (`global_schedule=False`, the evaluation's per-rank
shards) or its row slice of one global batch schedule that every rank
derives alike from the ark headers (`global_schedule`, the default with
more than one process, which training needs: every rank then runs the
same steps at the same shapes).  `Batch.score_mask` marks the rows that
count: wrap-around duplicates and the global schedule's tail padding do
not.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from mdd_tpu_torch.data.prefetch import shard_for_host_primary
from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.frontend import kaldi_io
from mdd_tpu_torch.frontend.augment import mutate_transcript, spec_augment
from mdd_tpu_torch.frontend.splice import (make_context, output_frames,
                                           pad_to_multiple, skip_frames)


@dataclasses.dataclass
class Batch:
    # (B, T, D): float32 numpy, or a bfloat16 torch tensor on the bfloat16
    # wire (numpy has no bfloat16)
    inputs: Union[np.ndarray, torch.Tensor]
    input_fracs: np.ndarray   # (B,) float32 — T_i / T_max
    targets: np.ndarray       # (B, L) int32
    target_sizes: np.ndarray  # (B,) int32
    trans: np.ndarray         # (B, L2) int32
    trans_sizes: np.ndarray   # (B,) int32
    utt_ids: List[str]
    # score_mask[i] False: a row run for equal shapes across ranks (a
    # wrap-around duplicate, the global schedule's tail padding) that the
    # loss, BN statistics and scoring leave out; None: every row counts
    score_mask: Optional[np.ndarray] = None

    @property
    def size(self) -> int:
        return self.inputs.shape[0]


def _read_keyed(path: str) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            utt, rest = line.split(" ", 1)
            out[utt] = rest.split()
    return out


class SpeechDataset:
    def __init__(
        self,
        vocab: Vocab,
        scp_path: str,
        lab_path: str,
        trans_path: str,
        left_ctx: int = 0,
        right_ctx: int = 2,
        n_skip_frame: int = 2,
        n_downsample: int = 2,
        train: bool = False,
        augment_mode: int = 2,
        mutation_prob: float = 0.1,
        device_frontend: bool = False,
    ):
        self.vocab = vocab
        self.left_ctx, self.right_ctx = left_ctx, right_ctx
        self.n_skip_frame, self.n_downsample = n_skip_frame, n_downsample
        self.train = train
        self.augment_mode = augment_mode
        self.mutation_prob = mutation_prob
        self.device_frontend = device_frontend

        scp = kaldi_io.read_scp(scp_path)
        labels = _read_keyed(lab_path)
        trans = _read_keyed(trans_path)
        self.items: List[Tuple[str, str, List[int], List[int]]] = []
        for utt, rx in scp.items():
            key = utt.split(".")[0]
            self.items.append((
                key, rx, vocab.encode(labels[key]), vocab.encode(trans[key])))
        if not len(self.items) == len(labels) == len(trans):
            raise ValueError("scp/label/transcript files disagree on the "
                             "utterance set")

    def __len__(self) -> int:
        return len(self.items)

    def feature_dim_out(self, feat_dim: int) -> int:
        return feat_dim * (self.left_ctx + 1 + self.right_ctx)

    def load_item(self, idx: int, rng: Optional[np.random.Generator] = None):
        """-> (feats (T, D'), label ids, trans ids, utt)."""
        utt, rx, label, trans = self.items[idx]
        feat = kaldi_io.load_mat(rx)
        if self.train and rng is not None:
            feat = spec_augment(feat, rng)
            trans = mutate_transcript(trans, self.vocab, rng,
                                      self.mutation_prob, self.augment_mode)
        if not self.device_frontend:
            feat = skip_frames(
                make_context(feat, self.left_ctx, self.right_ctx),
                self.n_skip_frame)
            feat = pad_to_multiple(feat, self.n_downsample)
        return feat.astype(np.float32), list(label), list(trans), utt


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_wire_dtype(wire_dtype: Optional[str]) -> torch.dtype:
    """Feature payload dtype on the host -> device wire: None / "" /
    "float32" -> float32, "bfloat16" -> bfloat16 (half the bytes; rounded
    to nearest even through torch, as ml_dtypes rounds in mdd_tpu)."""
    if wire_dtype in (None, "", "float32"):
        return torch.float32
    if wire_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unsupported wire_dtype {wire_dtype!r} "
                     "(float32 or bfloat16)")


class BucketedLoader:
    """Batching with shape bucketing.

    Batches are grouped by similar frame length; each batch's time axis is
    padded to a multiple of `time_quantum` and label axes to multiples of
    `label_quantum`.  With `process_count` > 1 every rank yields
    `batch_size` rows a batch: its slice of each global batch of
    `batch_size * process_count` rows (`global_schedule`, the default
    there), or batches of its own shard_for_host_primary share
    (`global_schedule=False`)."""

    def __init__(
        self,
        dataset: SpeechDataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        time_quantum: int = 64,
        label_quantum: int = 16,
        num_workers: int = 0,
        wire_dtype: Optional[str] = None,
        process_index: int = 0,
        process_count: int = 1,
        global_schedule: Optional[bool] = None,
    ):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} is not a rank "
                             f"of {process_count}")
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.time_quantum = time_quantum
        if dataset.device_frontend:
            # raw-grid bucketing: quantize on pre-skip frames so the
            # post-skip grid lands on the same time_quantum boundaries,
            # and batched_splice_skip's divisibility holds
            skip = max(dataset.n_skip_frame, 1)
            self.time_quantum = _round_up(time_quantum * skip,
                                          skip * dataset.n_downsample)
        self.label_quantum = label_quantum
        self.wire_dtype = resolve_wire_dtype(wire_dtype)
        self.num_workers = num_workers
        self._epoch = 0
        self.process_index = process_index
        self.process_count = process_count
        # the global schedule gives every rank the same shapes and batch
        # count by construction; per-rank shards of a bucketed corpus
        # may not, and a training step's collectives would then deadlock
        self.global_schedule = (process_count > 1 if global_schedule is None
                                else bool(global_schedule))
        self.shape_coordinated = self.global_schedule or process_count == 1
        if self.global_schedule:
            self._tlens, self._llens, self._l2lens = \
                self._schedule_lengths(dataset)
            self._order = np.arange(len(dataset))
            self._primary = np.ones(len(dataset), bool)
        else:
            order, primary = shard_for_host_primary(
                list(range(len(dataset))), process_index, process_count)
            self._order = np.asarray(order, np.int64)
            self._primary = np.asarray(primary, bool)

    @staticmethod
    def _schedule_lengths(dataset):
        """(post-transform frame, label, transcript) lengths an item, from
        the ark headers (no feature bytes read): SpecAugment and the
        transcript mutation keep lengths, so they hold for every epoch."""
        raw_rows = kaldi_io.matrix_rows([rx for _, rx, _, _ in dataset.items])
        if dataset.device_frontend:
            tlens = np.asarray(raw_rows, np.int64)
        else:
            tlens = np.asarray([output_frames(r, dataset.n_skip_frame,
                                              dataset.n_downsample)
                                for r in raw_rows], np.int64)
        llens = np.asarray([len(it[2]) for it in dataset.items], np.int64)
        l2lens = np.asarray([len(it[3]) for it in dataset.items], np.int64)
        return tlens, llens, l2lens

    def __len__(self) -> int:
        rows = self.batch_size * (self.process_count
                                  if self.global_schedule else 1)
        return -(-len(self._order) // rows)

    def set_epoch(self, epoch: int) -> None:
        """Fast-forward the epoch counter (checkpoint resume): augmentation
        rngs are keyed (seed + epoch, idx) and shuffles by seed + epoch,
        so a resumed run continues the original sequence.  Epoch e
        consumes counter value e - 1 (a fresh loader starts at 0)."""
        self._epoch = int(epoch)

    def _load_many(self, indices, epoch: int):
        """Load items, each with its own deterministic rng stream — the
        same batches whatever the worker count."""

        def load(i):
            rng = (np.random.default_rng((self.seed + epoch, int(i)))
                   if self.ds.train else None)
            return self.ds.load_item(int(i), rng)

        if self.num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(self.num_workers) as pool:
                return list(pool.map(load, indices))
        return [load(i) for i in indices]

    def __iter__(self) -> Iterator[Batch]:
        epoch = self._epoch
        rng = np.random.default_rng(self.seed + epoch)
        self._epoch += 1
        if self.global_schedule:
            yield from self._iter_global(epoch, rng)
            return
        order, primary = np.array(self._order), np.array(self._primary)
        if self.shuffle:
            perm = rng.permutation(len(order))
            order, primary = order[perm], primary[perm]
            window = self.batch_size * 16
        else:
            window = len(order)
        for wstart in range(0, len(order), window):
            widx = order[wstart:wstart + window]
            loaded = sorted(zip(self._load_many(widx, epoch),
                                primary[wstart:wstart + window]),
                            key=lambda it: it[0][0].shape[0])
            for bstart in range(0, len(loaded), self.batch_size):
                chunk = loaded[bstart:bstart + self.batch_size]
                yield self._collate([it for it, _ in chunk],
                                    np.asarray([p for _, p in chunk]))

    def _iter_global(self, epoch: int, rng) -> Iterator[Batch]:
        """The global batch schedule, alike on every rank: shuffle the
        corpus, sort each window of 16 global batches by the header
        lengths, cut global batches of batch_size * process_count rows;
        each rank loads only its row slice."""
        g = self.batch_size * self.process_count
        order = np.array(self._order)
        if self.shuffle:
            order = order[rng.permutation(len(order))]
            window = g * 16
        else:
            window = len(order)
        for wstart in range(0, len(order), window):
            widx = order[wstart:wstart + window]
            widx = widx[np.argsort(self._tlens[widx], kind="stable")]
            for bstart in range(0, len(widx), g):
                yield self._collate_global(list(widx[bstart:bstart + g]),
                                           epoch)

    def _collate_global(self, chunk, epoch: int) -> Batch:
        """This rank's rows of the global batch `chunk`, padded to the
        whole chunk's shapes (alike on every rank); a short tail is
        filled by repeating its last item, score_mask False."""
        g = self.batch_size * self.process_count
        n_real = len(chunk)
        chunk = chunk + [chunk[-1]] * (g - n_real)
        t_max = _round_up(int(self._tlens[chunk].max()), self.time_quantum)
        l_max = _round_up(int(self._llens[chunk].max()), self.label_quantum)
        l2_max = _round_up(int(self._l2lens[chunk].max()),
                           self.label_quantum)
        lo = self.process_index * self.batch_size
        slots = range(lo, lo + self.batch_size)
        score = np.asarray([s < n_real for s in slots])
        batch = self._collate(self._load_many([chunk[s] for s in slots],
                                              epoch), score,
                              (t_max, l_max, l2_max))
        batch.utt_ids = [u if ok else "<pad>"
                         for u, ok in zip(batch.utt_ids, score)]
        return batch

    def _collate(self, items, score: np.ndarray, shapes=None) -> Batch:
        """Zero-padded batch of loaded items; `shapes` = (T, L, L2) to pad
        to, else each rounded up from the items' longest."""
        b = len(items)
        if shapes is None:
            shapes = (
                _round_up(max(it[0].shape[0] for it in items),
                          self.time_quantum),
                _round_up(max(len(it[1]) for it in items),
                          self.label_quantum),
                _round_up(max(len(it[2]) for it in items),
                          self.label_quantum))
        t_max, l_max, l2_max = shapes
        inputs = np.zeros((b, t_max, items[0][0].shape[1]), np.float32)
        fracs = np.zeros(b, np.float32)
        targets = np.zeros((b, l_max), np.int32)
        tsizes = np.zeros(b, np.int32)
        trans = np.zeros((b, l2_max), np.int32)
        trsizes = np.zeros(b, np.int32)
        for i, (feat, label, tr, _) in enumerate(items):
            inputs[i, :feat.shape[0]] = feat
            fracs[i] = feat.shape[0] / t_max
            targets[i, :len(label)] = label
            tsizes[i] = len(label)
            trans[i, :len(tr)] = tr
            trsizes[i] = len(tr)
        wire = (inputs if self.wire_dtype == torch.float32
                else torch.from_numpy(inputs).to(self.wire_dtype))
        return Batch(wire, fracs, targets, tsizes, trans, trsizes,
                     [it[3] for it in items], score_mask=score)


def _repeat_last(a, pad: int):
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])
    return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)


def pad_batch_to(batch: Batch, batch_size: int) -> Tuple[Batch, np.ndarray]:
    """Pad a short batch to `batch_size` rows by repeating its last row;
    returns (batch, valid mask), the mask False on the added rows.  A
    ragged tail then runs at the loader's one batch size."""
    b = batch.size
    if b == batch_size:
        return batch, np.ones(b, bool)
    pad = batch_size - b
    rep = lambda a: _repeat_last(a, pad)
    mask = np.concatenate([np.ones(b, bool), np.zeros(pad, bool)])
    score = (None if batch.score_mask is None else
             np.concatenate([batch.score_mask, np.zeros(pad, bool)]))
    return Batch(rep(batch.inputs), rep(batch.input_fracs), rep(batch.targets),
                 rep(batch.target_sizes), rep(batch.trans),
                 rep(batch.trans_sizes), batch.utt_ids + ["<pad>"] * pad,
                 score_mask=score), mask
