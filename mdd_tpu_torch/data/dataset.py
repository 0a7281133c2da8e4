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
The multi-process loaders (host sharding, the device-resident cache) wait
for the port's scale-out slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.frontend import kaldi_io
from mdd_tpu_torch.frontend.augment import mutate_transcript, spec_augment
from mdd_tpu_torch.frontend.splice import (make_context, pad_to_multiple,
                                           skip_frames)


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
    """Batching with shape bucketing, in one process.

    Batches are grouped by similar frame length; each batch's time axis is
    padded to a multiple of `time_quantum` and label axes to multiples of
    `label_quantum`.  mdd_tpu's global schedule (multi-process runs) waits
    for the port's scale-out slice.
    """

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
    ):
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
        self._order = np.arange(len(dataset))

    def __len__(self) -> int:
        return -(-len(self._order) // self.batch_size)

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
        order = np.array(self._order)
        if self.shuffle:
            order = order[rng.permutation(len(order))]
            window = self.batch_size * 16
        else:
            window = len(order)
        for wstart in range(0, len(order), window):
            widx = order[wstart:wstart + window]
            loaded = sorted(self._load_many(widx, epoch),
                            key=lambda it: it[0].shape[0])
            for bstart in range(0, len(loaded), self.batch_size):
                yield self._collate(loaded[bstart:bstart + self.batch_size])

    def _collate(self, items) -> Batch:
        """Zero-padded batch of loaded items."""
        b = len(items)
        t_max = _round_up(max(it[0].shape[0] for it in items),
                          self.time_quantum)
        l_max = _round_up(max(len(it[1]) for it in items), self.label_quantum)
        l2_max = _round_up(max(len(it[2]) for it in items), self.label_quantum)
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
                     [it[3] for it in items])


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
    return Batch(rep(batch.inputs), rep(batch.input_fracs), rep(batch.targets),
                 rep(batch.target_sizes), rep(batch.trans),
                 rep(batch.trans_sizes), batch.utt_ids + ["<pad>"] * pad), mask
