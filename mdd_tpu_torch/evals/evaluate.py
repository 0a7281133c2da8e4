"""MDD evaluation harness: decode a test set, score PER + TA/FR/FA/TR
(counterpart of mdd_tpu/evals/evaluate.py).

The equivalent of the reference's
egs/attention_aug/steps/test_ctc_nosil.py: a batched forward over the
bucketed loader, greedy or prefix-beam decoding, sil-stripping, three
pairwise alignments per utterance, hierarchical MDD accounting with a
per-accent (default Mandarin, speaker prefix TXHC) breakdown, and the
decode_seq/human_seq/transcribe dump files the Kaldi scoring path
(result/mdd_result.sh) consumes.

The pure accounting lives in ``score_mdd`` so it can be tested directly.
With ``EvalSession.attach_cache`` the session decodes the CachedBatches of
a device-resident test split (data/device_cache.py), each gathered where
the corpus lies.

Several processes: each rank decodes its own share of the test split on
its own device (the loader's per-rank shards; rows whose score_mask is
False, the wrap-around duplicates, are decoded but not scored), writes
its dumps under `rank<r>/`, and `all_reduce_report` sums the integer
tallies so every rank prints the global report.
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mdd_tpu_torch.align.levenshtein import align
from mdd_tpu_torch.align.mdd import (
    MddCounts,
    alignment_to_slots,
    mdd_accumulate,
    mdd_accumulate_subset,
)
from mdd_tpu_torch.data.dataset import Batch, pad_batch_to
from mdd_tpu_torch.data.device_cache import CachedBatch
from mdd_tpu_torch.data.prefetch import ThreadedLoader
from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.decode.greedy import best_path, collapse_ctc
from mdd_tpu_torch.frontend.splice import batched_splice_skip
from mdd_tpu_torch.models.ctc_model import CTCAttentionModel, ModelConfig
from mdd_tpu_torch.parallel import mesh
from mdd_tpu_torch.train.loop import exact_output_sizes
from mdd_tpu_torch.utils.precision import strict_float32


@dataclass
class MddReport:
    counts: MddCounts = field(default_factory=MddCounts)
    accent_counts: MddCounts = field(default_factory=MddCounts)
    errors: int = 0
    tokens: int = 0
    accent_errors: int = 0
    accent_tokens: int = 0
    n_utts: int = 0
    decode_minutes: float = 0.0

    @property
    def per(self) -> float:
        return 100.0 * self.errors / self.tokens if self.tokens else 0.0

    @property
    def accent_per(self) -> float:
        return (100.0 * self.accent_errors / self.accent_tokens
                if self.accent_tokens else 0.0)


def _strip_sil(tokens: Sequence[str]) -> List[str]:
    return [t for t in tokens if t != "sil"]


def score_mdd(
    triples: Iterable[Tuple[str, Sequence[str], Sequence[str], Sequence[str]]],
    accent_prefixes: Tuple[str, ...] = ("TXHC",),
    strip_sil: bool = True,
) -> MddReport:
    """Score (utt, decoded, label, canonical) phone sequences.

    Reproduces test_ctc_nosil.py:218-298: PER = edit-distance(decoded,
    label) over label tokens; MDD counts from the label<->canonical and
    decoded<->canonical alignment slot dicts.  `accent_prefixes` selects
    the per-accent subset by utterance-id prefix (reference: utt[:4] in
    ['TXHC']).
    """
    rep = MddReport()
    for utt, decoded, label, canonical in triples:
        if strip_sil:
            decoded = _strip_sil(decoded)
            label = _strip_sil(label)
            canonical = _strip_sil(canonical)
        in_accent = any(utt.startswith(p) for p in accent_prefixes)

        _, lc_path = align(label, canonical)
        dist, _ = align(decoded, label)
        _, dc_path = align(decoded, canonical)

        d1 = alignment_to_slots(label, canonical, lc_path)
        d2 = alignment_to_slots(decoded, canonical, dc_path)
        if in_accent:
            mdd_accumulate(copy.deepcopy(d1), copy.deepcopy(d2), rep.counts)
            mdd_accumulate_subset(d1, d2, rep.accent_counts)
            rep.accent_errors += dist
            rep.accent_tokens += len(label)
        else:
            mdd_accumulate(d1, d2, rep.counts)

        rep.errors += dist
        rep.tokens += len(label)
        rep.n_utts += 1
    return rep


_COUNT_FIELDS = ("true_accept", "false_rejection", "false_accept",
                 "tr_correct_diag", "tr_wrong_diag", "total_canonical_phones")
_REPORT_FIELDS = ("errors", "tokens", "accent_errors", "accent_tokens",
                  "n_utts")


def report_to_vector(rep: MddReport) -> np.ndarray:
    """Flatten the integer tallies of an MddReport into one int64 vector
    (counts, accent_counts, then scalar fields): the form in which the
    scorer thread sums its chunks."""
    vals = [getattr(rep.counts, f) for f in _COUNT_FIELDS]
    vals += [getattr(rep.accent_counts, f) for f in _COUNT_FIELDS]
    vals += [getattr(rep, f) for f in _REPORT_FIELDS]
    return np.asarray(vals, np.int64)


def report_from_vector(vec: np.ndarray) -> MddReport:
    vec = [int(v) for v in np.asarray(vec)]
    n = len(_COUNT_FIELDS)
    counts = MddCounts(**dict(zip(_COUNT_FIELDS, vec[:n])))
    accent = MddCounts(**dict(zip(_COUNT_FIELDS, vec[n:2 * n])))
    rep = MddReport(counts=counts, accent_counts=accent)
    for f, v in zip(_REPORT_FIELDS, vec[2 * n:]):
        setattr(rep, f, v)
    return rep


def all_reduce_report(rep: MddReport) -> MddReport:
    """Sum an MddReport's tallies over the ranks (each decoded its own
    share of the test split); the report itself in one process.
    decode_minutes stays the rank's own (wall clock, not summable)."""
    if mesh.process_count() == 1:
        return rep
    out = report_from_vector(mesh.all_reduce_metrics(report_to_vector(rep)))
    out.decode_minutes = rep.decode_minutes
    return out


def _format_counts(c: MddCounts, errors: int, tokens: int) -> List[str]:
    per = 100.0 * errors / tokens if tokens else 0.0
    lines = [
        f"total_error: {errors}",
        f"total_phoneme: {tokens}",
        "Phoneme error rate on test set: %.4f" % per,
        "total :  %d %d" % (c.total_canonical_phones,
                            c.true_accept + c.false_rejection
                            + c.false_accept + c.true_rejection),
        "TA :  %d" % c.true_accept,
        "FR :  %d" % c.false_rejection,
        "FA :  %d" % c.false_accept,
        "TR :  %d" % c.true_rejection,
        "TR correct :  %d" % c.tr_correct_diag,
        "TR wrong :   %d" % c.tr_wrong_diag,
        "Precision : %.4f" % (c.precision * 100),
        "Recall : %.4f" % (c.recall * 100),
        "F1 score : %.4f" % (c.f1 * 100),
    ]
    return lines


def format_mdd_report(rep: MddReport, accent_name: str = "mandarin") -> str:
    lines = ["-" * 13 + " all languages " + "-" * 13]
    lines += _format_counts(rep.counts, rep.errors, rep.tokens)
    lines += ["-" * 15 + f" {accent_name} " + "-" * 15]
    lines += _format_counts(rep.accent_counts, rep.accent_errors,
                            rep.accent_tokens)
    lines.append("time used for decode %d sentences: %.4f minutes."
                 % (rep.n_utts, rep.decode_minutes))
    return "\n".join(lines)


class EvalSession:
    """The model on one device, eval mode, plus greedy or beam decoding.

    `forwards` counts the model forwards this session ran."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        state_dict: Dict[str, torch.Tensor],
        vocab: Vocab,
        decode_type: str = "greedy",
        beam_width: int = 10,
        lm_path: Optional[str] = None,
        lm_alpha: float = 0.0,
        host_beam: bool = False,
        device: str | torch.device = "cuda",
        device_frontend: bool = False,
        left_ctx: int = 0,
        right_ctx: int = 2,
        n_skip_frame: int = 2,
        n_downsample: int = 2,
    ):
        self.cfg = model_cfg
        self.vocab = vocab
        self.device = torch.device(device)
        # device_frontend: batches arrive as RAW (B, T_raw, D) features
        # (bfloat16 on the wire); context splice + frame skip run on the
        # device before the forward.  Same contract as the Trainer's.
        self.device_frontend = device_frontend
        self.left_ctx, self.right_ctx = left_ctx, right_ctx
        self.n_skip_frame, self.n_downsample = n_skip_frame, n_downsample
        strict_float32(self.device, model_cfg.compute_dtype)
        self.model = CTCAttentionModel(model_cfg)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self.forwards = 0
        self.cache = None
        # decode_type semantics follow the reference: anything that is not
        # 'greedy'/'Greedy' selects the beam decoder, including the
        # committed config value "Nono" (test_ctc_nosil.py:135-138).
        self.greedy = decode_type.lower() == "greedy"
        if not self.greedy:
            lm = None
            if lm_path:
                from mdd_tpu_torch.decode.arpa import ArpaBigramLM
                lm = ArpaBigramLM(lm_path)
            if host_beam:
                from mdd_tpu_torch.decode.beam import BeamSearchDecoder
                self.beam = BeamSearchDecoder(
                    vocab.index2word, beam_width=beam_width, lm=lm,
                    lm_alpha=lm_alpha)
            else:
                from mdd_tpu_torch.decode.beam_jit import BatchedBeamDecoder
                self.beam = BatchedBeamDecoder(
                    vocab.index2word, beam_width=beam_width, lm=lm,
                    lm_alpha=lm_alpha, device=self.device)

    def attach_cache(self, cache) -> None:
        """Decode CachedBatches of `cache` (a DeviceFeatureCache on this
        session's device): a pass then moves index vectors and labels to
        the device, not features, and decodes what the streaming path
        decodes for the same utterances."""
        if not self.device_frontend:
            raise ValueError("cached evaluation decodes raw features; build "
                             "the EvalSession with device_frontend=True")
        if mesh.process_count() > 1:
            raise ValueError("cached evaluation runs in one process; "
                             "several ranks decode through the streaming "
                             "loader")
        self.cache = cache

    def stage_batch(self, batch):
        """Move the batch's model inputs to the device; a CachedBatch's
        features are gathered from the attached cache there.

        Split out of decode_batch so a staging thread can prepare batch
        N+1 while batch N decodes.  Returns (batch, device tensors) for
        decode_staged."""
        put = lambda a: torch.as_tensor(a).to(self.device, non_blocking=True)
        if isinstance(batch, CachedBatch):
            if self.cache is None:
                raise ValueError("a CachedBatch needs attach_cache(cache)")
            return batch, (*self.cache.gather(batch),
                           put(batch.trans).long(),
                           put(batch.trans_sizes).long())
        inputs = put(batch.inputs)
        if not self.device_frontend:
            inputs = inputs.float()
        return batch, (inputs, put(batch.input_fracs),
                       put(batch.trans).long(), put(batch.trans_sizes).long())

    @torch.inference_mode()
    def _forward(self, inputs, fracs, trans, trsizes):
        """-> ((T', B, C) log-probs on the device, (B,) host frame counts)."""
        model_frames = None
        if self.device_frontend:
            raw_len = torch.round(fracs * inputs.shape[1]).long()
            inputs, model_frames = batched_splice_skip(
                inputs, raw_len, self.left_ctx, self.right_ctx,
                self.n_skip_frame, self.n_downsample)
        log_probs = self.model(inputs, trans, trsizes)
        self.forwards += 1
        out_len = log_probs.shape[0]
        if model_frames is not None:
            frames = exact_output_sizes(model_frames, out_len,
                                        inputs.shape[1])
        else:
            frames = (fracs * out_len).to(torch.int32)
        return log_probs, frames.cpu().numpy().astype(np.int32)

    def decode_batch(self, batch) -> Tuple[List[List[str]], np.ndarray]:
        """-> (decoded phone lists, output frame counts).  Takes a Batch,
        or a CachedBatch after attach_cache."""
        return self.decode_staged(self.stage_batch(batch))

    def decode_staged(self, staged) -> Tuple[List[List[str]], np.ndarray]:
        """Decode a batch already staged on the device by stage_batch."""
        _, arrays = staged
        log_probs, frames = self._forward(*arrays)
        if self.greedy:
            ids = best_path(log_probs)
            seqs = [collapse_ctc(ids[b], int(frames[b]))
                    for b in range(len(ids))]
        elif hasattr(self.beam, "decode_log"):
            # device beam: the log-softmax goes straight in, where it lies
            seqs = self.beam.decode_log(log_probs.transpose(0, 1),
                                        frames.tolist())
        else:
            probs = np.exp(log_probs.cpu().numpy()).transpose(1, 0, 2)
            seqs = self.beam.decode(probs, frames.tolist())
        return [self.vocab.decode(s) for s in seqs], frames


def _ladder_size(n: int, batch_size: int, n_dev: int = 1) -> int:
    """Pad target for a ragged tail batch: the next power of two >= n
    (and >= n_dev, 1 on one device), capped at the loader's batch size.

    A 1-utterance tail in a length bucket would otherwise pay a full
    `batch_size`-wide forward; the pow-2 ladder bounds the waste at <2x
    the tail's own work while keeping the set of shapes small.  Eval-mode
    BN uses running stats and every other op is per-sample, so metrics
    are identical at any padded width.
    """
    p = max(n_dev, 1)
    while p < n:
        p *= 2
    return min(p, batch_size) if batch_size >= n else n


class _AsyncScorer:
    """Scores decoded batches in a worker thread so host-side alignment +
    MDD accounting for batch N overlap the device forward/decode of batch
    N+1.

    All MddReport tallies are order-independent integer sums, so chunked
    accumulation is identical to one score_mdd pass over the full triple
    list.  `join` ends the thread and returns the report; `close` ends it
    without a result (the caller is already failing).
    """

    def __init__(self, accent_prefixes: Tuple[str, ...]):
        self.accent_prefixes = accent_prefixes
        self.vec = np.zeros(len(_COUNT_FIELDS) * 2 + len(_REPORT_FIELDS),
                            np.int64)
        self.q: "queue.Queue" = queue.Queue(maxsize=8)
        self.err: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while True:
            chunk = self.q.get()
            if chunk is None:
                return
            if self.err is not None:
                continue   # keep draining so a blocked submit() can't
                # deadlock the eval loop; the error surfaces on join()
            try:
                rep = score_mdd(chunk, self.accent_prefixes)
                self.vec += report_to_vector(rep)
            except BaseException as e:  # noqa: BLE001 — surfaced on join
                self.err = e

    def submit(self, chunk: List) -> None:
        if self.err is None:
            self.q.put(chunk)

    def close(self) -> None:
        """End the worker thread if it still runs (no-op after join)."""
        if self.thread.is_alive():
            self.q.put(None)
            self.thread.join()

    def join(self) -> MddReport:
        self.close()
        if self.err is not None:
            raise self.err
        return report_from_vector(self.vec)


def evaluate_model(
    session: EvalSession,
    loader: Iterable[Batch],
    accent_prefixes: Tuple[str, ...] = ("TXHC",),
    dump_dir: Optional[str] = None,
    log=print,
    overlap_scoring: bool = True,
) -> MddReport:
    """Decode the whole loader and score (test_ctc_nosil.py:165-338).

    With `overlap_scoring` (default) the 3-way alignment + MDD accounting
    runs in a worker thread pipelined one batch behind the forward/decode,
    and a second thread stages the next batch on the device; tallies are
    identical either way (order-independent integer sums).  Both threads
    are ended when decoding raises.
    """
    vocab = session.vocab
    triples = []
    scorer = _AsyncScorer(accent_prefixes) if overlap_scoring else None
    start = time.time()
    batch_size = getattr(loader, "batch_size", None)

    def padded(batch):
        if isinstance(batch, CachedBatch):
            # the CachedLoader pads to one shape a bucket and marks its
            # padding rows itself
            return batch, batch.valid
        valid = np.ones(batch.size, bool)
        if batch_size and batch.size < batch_size:
            # pad the ragged tail up the pow-2 ladder (not to the full
            # batch size) so a short tail pays a proportionate forward
            batch, valid = pad_batch_to(
                batch, _ladder_size(batch.size, batch_size))
        if batch.score_mask is not None:
            # wrap-around duplicates: decoded (every rank runs as many
            # batches) but scored on the rank that owns them
            valid = valid & batch.score_mask
        return batch, valid

    def staged_iter():
        """Stage batch N+1 on the device while batch N decodes (plain
        generator when overlap is off)."""
        staged = ((session.stage_batch(b), v)
                  for b, v in (padded(batch) for batch in loader))
        if not overlap_scoring:
            yield from staged
            return
        yield from ThreadedLoader(staged, prefetch=2)

    batches = staged_iter()
    try:
        for staged, valid in batches:
            batch = staged[0]
            decoded, _ = session.decode_staged(staged)
            chunk = []
            for i, utt in enumerate(batch.utt_ids):
                if not valid[i]:
                    continue
                label = vocab.decode(
                    batch.targets[i][: batch.target_sizes[i]])
                canonical = vocab.decode(
                    batch.trans[i][: batch.trans_sizes[i]])
                chunk.append((utt, decoded[i], label, canonical))
            if scorer is not None:
                scorer.submit(chunk)
            # triples feed the dump files (and the serial scoring path);
            # keeping them is a few strings per utterance
            triples.extend(chunk)

        if dump_dir is not None:
            d = Path(dump_dir)
            if mesh.process_count() > 1:
                # each rank holds its share's triples: one directory a
                # rank (cat rank*/x puts the whole set together)
                d = d / f"rank{mesh.process_index()}"
            d.mkdir(parents=True, exist_ok=True)
            with open(d / "decode_seq.log", "w") as w1, \
                 open(d / "human_seq.log", "w") as w2, \
                 open(d / "transcribe.log", "w") as w3:
                for utt, decoded, label, canonical in triples:
                    w1.write(f"{utt} {' '.join(_strip_sil(decoded))}\n")
                    w2.write(f"{utt} {' '.join(_strip_sil(label))}\n")
                    w3.write(f"{utt} {' '.join(_strip_sil(canonical))}\n")

        rep = (scorer.join() if scorer is not None
               else score_mdd(triples, accent_prefixes))
    finally:
        batches.close()          # ends the staging thread
        if scorer is not None:
            scorer.close()       # ends the scorer thread on any exit
    rep.decode_minutes = (time.time() - start) / 60.0
    rep = all_reduce_report(rep)
    log(format_mdd_report(rep))
    return rep
