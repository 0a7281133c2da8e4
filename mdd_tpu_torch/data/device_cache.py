"""Device-resident feature corpus (counterpart of
mdd_tpu/data/device_cache.py).

The streaming loader reads, augments, pads and ships every feature matrix
to the device each epoch, though the features never change: only the
SpecAugment geometry and the canonical-transcript mutation do, and both
are metadata-sized.  So the raw 81-dim features go to the device once,
stacked into one (n_b, T_b, 81) tensor per raw-length bucket in the wire
dtype, and each batch is formed there by an `index_select` from an index
vector.  A step then ships a few KB (row indices, lengths, 4 SpecAugment
ints an item, label ids) instead of the padded feature batch.

The batches equal mdd_tpu's field for field: the same buckets, the same
per-epoch permutation and batch shuffle from default_rng(seed + epoch),
and each item's Generator keyed (seed + epoch, index) and drawn in the
order of SpeechDataset.load_item (SpecAugment geometry, then transcript
mutation).  So the gathered and masked features are the bits the
streaming loader would have shipped for the same items.

Several processes: the CachedLoader cuts one global batch schedule, alike
on every rank, and each rank takes its row slice of every global batch
(`global_idx` keeps the whole batch's rows).  With `shard_rows` each rank
holds 1/N of every bucket's rows; a batch is then assembled by each rank
taking the rows it owns for every slot of the global batch, exact zeros
elsewhere, and one reduction over the ranks that hands each its own
slots.  The sum runs on the payload's bytes, and exactly one rank
contributes each slot, so the batch equals the replicated gather bit for
bit (DeviceFeatureCache._gather_sharded).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mdd_tpu_torch.data.dataset import (SpeechDataset, _round_up,
                                        resolve_wire_dtype)
from mdd_tpu_torch.frontend import kaldi_io
from mdd_tpu_torch.frontend.augment import (mutate_transcript,
                                            sample_spec_augment_params)
from mdd_tpu_torch.parallel import mesh


@dataclasses.dataclass
class CachedBatch:
    """One batch as coordinates into the device-resident corpus: `idx`
    indexes rows of the bucket's tensor; every field is host-sized."""

    bucket: int               # raw-frame bucket width (key of the tensor)
    idx: np.ndarray           # (B,) int32 — rows of the bucket tensor
    lengths: np.ndarray       # (B,) int32 — true raw frame counts
    aug: np.ndarray           # (B, 4) int32 — [f, f0, w, t0]; zeros = no-op
    targets: np.ndarray       # (B, L) int32
    target_sizes: np.ndarray  # (B,) int32
    trans: np.ndarray         # (B, L2) int32 — mutated when training
    trans_sizes: np.ndarray   # (B,) int32
    utt_ids: List[str]
    valid: np.ndarray         # (B,) bool — False rows are batch padding
    score_mask: Optional[np.ndarray] = None   # rows that are scored
    # (B_global,) int32: the whole global batch's rows, alike on every
    # rank (the row-sharded gather needs every slot's); equals idx in one
    # process
    global_idx: Optional[np.ndarray] = None

    @property
    def size(self) -> int:
        return self.idx.shape[0]


class DeviceFeatureCache:
    """A SpeechDataset's raw features, read once and kept on `device`.

    Items are grouped by raw length rounded up to the raw-grid quantum of
    the streaming loader's device-frontend mode (so batched_splice_skip's
    divisibility holds), one zero-padded (n_b, T_b, D) tensor a bucket.
    `bucket_items[b]` lists bucket b's items in corpus order, `row_of[i]`
    is item i's row in its bucket; `bytes` the tensors' size.

    `shard_rows` (the default) splits every bucket's rows, padded to a
    multiple of `process_count`, into contiguous equal shares: rank
    `process_index` keeps rows [r * m, (r + 1) * m), `bytes_per_device`
    of them; the CachedLoader over it takes the same two.  In one process
    that is the whole corpus, as with `shard_rows=False`.  A corpus that
    does not fit raises (torch's out-of-memory error)."""

    def __init__(self, dataset: SpeechDataset, device: str | torch.device,
                 time_quantum: int = 64, wire_dtype: str = "bfloat16",
                 shard_rows: bool = True, process_index: int = 0,
                 process_count: int = 1):
        if not dataset.device_frontend:
            raise ValueError(
                "DeviceFeatureCache needs a device_frontend dataset: the "
                "cache holds raw features, spliced on the device")
        self.ds = dataset
        self.device = torch.device(device)
        self.process_index = process_index if shard_rows else 0
        self.process_count = process_count if shard_rows else 1
        skip = max(dataset.n_skip_frame, 1)
        self.raw_quantum = _round_up(time_quantum * skip,
                                     skip * dataset.n_downsample)
        dtype = resolve_wire_dtype(wire_dtype)
        feats = kaldi_io.bulk_load([rx for _, rx, _, _ in dataset.items])
        self.feat_dim = feats[0].shape[1]
        self.lengths = np.asarray([f.shape[0] for f in feats], np.int32)
        self.bucket_items: Dict[int, List[int]] = {}
        self.row_of = np.zeros(len(feats), np.int32)
        for i, t in enumerate(self.lengths):
            rows = self.bucket_items.setdefault(
                _round_up(int(t), self.raw_quantum), [])
            self.row_of[i] = len(rows)
            rows.append(i)
        self.buckets: Dict[int, torch.Tensor] = {}
        self.bytes = self.bytes_per_device = 0
        n, r = self.process_count, self.process_index
        for b, rows in self.bucket_items.items():
            # pad rows never appear in row_of, so they are never gathered
            m = -(-len(rows) // n)
            mine = rows[r * m:(r + 1) * m]
            # rounded to the wire dtype row by row (bf16: to nearest even,
            # as the streaming loader's wire), then one upload a bucket
            arr = torch.zeros((m, b, self.feat_dim), dtype=dtype)
            for k, i in enumerate(mine):
                arr[k, :feats[i].shape[0]] = torch.from_numpy(feats[i])
            self.bytes_per_device += arr.numel() * arr.element_size()
            self.bytes += n * arr.numel() * arr.element_size()
            self.buckets[b] = arr.to(self.device)

    def __len__(self) -> int:
        return len(self.ds)

    def gather(self, batch: CachedBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (the batch's raw features, (B, T_bucket, D) on the cache's
        device, gathered from its bucket by `index_select`, as mdd_tpu's
        `make_cache_assemble`; their lengths as fractions of T_bucket).
        Only the index and length vectors cross to the device, and with
        the rows sharded over several processes the batch's payload once
        between the ranks."""
        put = lambda a: torch.as_tensor(a).to(self.device, non_blocking=True)
        shard = self.buckets[batch.bucket]
        if self.process_count == 1:
            inputs = shard.index_select(0, put(batch.idx).long())
        else:
            inputs = self._gather_sharded(shard, put(batch.global_idx).long())
        return inputs, put(batch.lengths).float() / inputs.shape[1]

    def _gather_sharded(self, shard: torch.Tensor,
                        gidx: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the global batch `gidx`: the rows it owns
        (`shard` holds rows [r * m, (r + 1) * m) of the bucket), exact
        zeros for the others' slots, summed over the ranks and scattered,
        each rank receiving its own slots.  The sum runs on the bytes
        (x + 0 = x for any dtype, -0.0 included)."""
        m = shard.shape[0]
        local = gidx - self.process_index * m
        mine = (local >= 0) & (local < m)
        rows = shard.index_select(0, local.clamp(0, m - 1))
        contrib = torch.where(mine[:, None, None], rows,
                              torch.zeros((), dtype=rows.dtype,
                                          device=rows.device))
        g, t, d = contrib.shape
        out = mesh.reduce_scatter_rows(
            contrib.reshape(g, -1).contiguous().view(torch.uint8))
        return out.view(rows.dtype).reshape(g // self.process_count, t, d)


class CachedLoader:
    """CachedBatches over a DeviceFeatureCache, epoch by epoch.

    The streaming loader's contract (batch_size, shuffle keyed by the
    epoch, set_epoch for resume), with index batches: every batch is
    padded to batch_size by repeating its last row with valid=False, so
    each bucket runs at one shape.  With `process_count` > 1 the schedule
    is cut in global batches of batch_size * process_count items, alike on
    every rank, and rank `process_index` gets rows [r * batch_size,
    (r + 1) * batch_size) of each: every rank runs the same steps at the
    same shapes, and each utterance sits in one slot of one batch."""

    def __init__(self, cache: DeviceFeatureCache, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 label_quantum: int = 16, process_index: int = 0,
                 process_count: int = 1):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} is not a rank "
                             f"of {process_count}")
        self.cache = cache
        self.ds = cache.ds
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.label_quantum = label_quantum
        self.process_index = process_index
        self.process_count = process_count
        self._global_chunk = batch_size * process_count
        self._epoch = 0

    def __len__(self) -> int:
        return sum(-(-len(rows) // self._global_chunk)
                   for rows in self.cache.bucket_items.values())

    def set_epoch(self, epoch: int) -> None:
        """Fast-forward the epoch counter (checkpoint resume): shuffles
        and augmentation are keyed by the epoch, so a resumed run continues
        the original sequence.  Epoch e consumes counter value e - 1."""
        self._epoch = int(epoch)

    def schedule(self, epoch: int) -> List[Tuple[int, List[int]]]:
        """Epoch `epoch`'s (bucket, item indices) global batches, in
        order."""
        rng = np.random.default_rng(self.seed + epoch)
        batches: List[Tuple[int, List[int]]] = []
        for b in sorted(self.cache.bucket_items):
            rows = self.cache.bucket_items[b]
            order = (rng.permutation(len(rows)) if self.shuffle
                     else range(len(rows)))
            chunk: List[int] = []
            for j in order:
                chunk.append(rows[j])
                if len(chunk) == self._global_chunk:
                    batches.append((b, chunk))
                    chunk = []
            if chunk:
                batches.append((b, chunk))
        if self.shuffle:
            rng.shuffle(batches)  # type: ignore[arg-type]
        return batches

    def __iter__(self) -> Iterator[CachedBatch]:
        epoch = self._epoch
        self._epoch += 1
        for b, chunk in self.schedule(epoch):
            yield self._make_batch(b, chunk, epoch)

    def _make_batch(self, bucket: int, chunk: Sequence[int],
                    epoch: int) -> CachedBatch:
        """The global batch of `chunk` (every rank draws every row's
        augmentation: the label widths span the whole batch), then this
        rank's row slice of it."""
        cache, ds = self.cache, self.ds
        n_real, b = len(chunk), self._global_chunk
        idx = np.zeros(b, np.int32)
        lengths = np.zeros(b, np.int32)
        aug = np.zeros((b, 4), np.int32)
        valid = np.arange(b) < n_real
        utts: List[str] = []
        labels: List[List[int]] = []
        transcripts: List[List[int]] = []
        for k in range(b):
            i = chunk[min(k, n_real - 1)]
            utt, _, label, trans = ds.items[i]
            t = int(cache.lengths[i])
            if ds.train and valid[k]:
                # the streaming loader's Generator key and draw order
                # (BucketedLoader._load_many -> SpeechDataset.load_item)
                irng = np.random.default_rng((self.seed + epoch, int(i)))
                aug[k] = sample_spec_augment_params(t, cache.feat_dim, irng)
                trans = mutate_transcript(trans, ds.vocab, irng,
                                          ds.mutation_prob, ds.augment_mode)
            idx[k] = cache.row_of[i]
            lengths[k] = t
            utts.append(utt if valid[k] else "<pad>")
            labels.append(list(label))
            transcripts.append(list(trans))
        l_max = _round_up(max(map(len, labels)), self.label_quantum)
        l2_max = _round_up(max(map(len, transcripts)), self.label_quantum)
        targets = np.zeros((b, l_max), np.int32)
        trans_a = np.zeros((b, l2_max), np.int32)
        for k in range(b):
            targets[k, :len(labels[k])] = labels[k]
            trans_a[k, :len(transcripts[k])] = transcripts[k]
        tsizes = np.asarray([len(l) for l in labels], np.int32)
        trsizes = np.asarray([len(t) for t in transcripts], np.int32)
        lo = self.process_index * self.batch_size
        sl = slice(lo, lo + self.batch_size)
        # each utterance sits in one slot: every valid row is scored
        return CachedBatch(bucket, idx[sl], lengths[sl], aug[sl],
                           targets[sl], tsizes[sl], trans_a[sl], trsizes[sl],
                           utts[sl], valid[sl], score_mask=valid[sl].copy(),
                           global_idx=idx)
