"""Batched CTC prefix beam search on the device, in torch ops.

Counterpart of mdd_tpu/decode/beam_jit.py, the fixed-width re-architecture
of the host beam search (decode/beam.py, the semantic ground truth
mirroring reference utils/BeamSearch.py:35-153).  Dynamic prefix dicts do
not vectorize, so every batch row keeps a fixed-K beam state:

  prefixes (B, K, T) int64     label history (padded)
  lengths  (B, K)              prefix lengths
  last     (B, K)              last label (or the <s> sentinel V)
  h1, h2   (B, K) int32        double rolling hash of the prefix
  p_b, p_nb (B, K) float32     log P(prefix ending in blank / non-blank)

The leading B axis is written out where mdd_tpu vmaps, and a Python loop
over the frames takes the place of its lax.scan.  Each frame expands K
beams into K "stay" + K*C "extend" candidates and merges candidates that
reach the same prefix.  The merge exploits the structure of the candidate
set: live beams are pairwise-distinct prefixes, so two stays never merge,
and two extensions merge only if their (parent, label) pairs produce equal
sequences, impossible for distinct parents of a deduplicated beam.  The
ONLY possible merge is an extension landing on another beam's stay
(parent + [c] == beam_j): a (K*C, K) hash-equality test and a masked
log-sum-exp folded into the stay scores.  The K best of the (now
pairwise-distinct) candidates close the frame.  Reference semantics
preserved exactly:

  * blank-dominated frame skip: 1 - p_t(blank) < 0.1 (BeamSearch.py:93-94);
  * repeat-vs-blank gate with the p_{t-1}(blank) >= 0.9 quirk (:109-116);
  * bigram LM fusion on extension via a dense (V+1, V+1) matrix
    compiled from the ARPA file (NgramLM semantics incl. backoff);
  * end-of-sequence LM term and length normalization (:130-145).

The K best are the head of a stable descending sort of the K + K*C
candidates, not torch.topk: the candidate vector is full of exact ties at
NEG_INF, jax.lax.top_k returns the lowest index first among equals, and
torch.topk promises no order among them (least of all on CUDA), while a
stable sort keeps equal values in index order on every device.  Which
dead candidate fills a free beam slot decides the hashes the next frame
merges on, so the tie order is part of the function.

The hashes are torch.int32 and rely on wrap-around products, as the JAX
version's do.  Hash collisions between distinct prefixes would merge them
incorrectly; with two independent 32-bit rolling hashes the probability is
~2^-62 per candidate pair, negligible (and covered by the equivalence
tests).

The loop launches about 83 small ops a frame (9,151 device ops for 110
frames at B=64, K=10, C=43 under torch.profiler on an H100): on a GPU it
is bound by the host's launch rate, not by the device.  So `beam_search`,
which BatchedBeamDecoder calls, sends a CUDA tensor to the hand-written
kernel of ops/beam_cuda.py (csrc/ctc_beam.cu: the whole frame loop in one
launch, one block a row, the same sequences) and a CPU tensor to
`beam_search_batch`, the plain version.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from mdd_tpu_torch.ops.beam_cuda import ctc_beam_kernel

NEG_INF = -1e30
_MUL1 = 1000003
_MUL2 = -1640531527  # 2654435769 as int32 (Knuth)


@torch.no_grad()
def beam_search_batch(
    log_probs: torch.Tensor,     # (B, T, C) float32 log probabilities
    lengths: torch.Tensor,       # (B,) valid frame counts
    lm_matrix: torch.Tensor,     # (V+1, V+1) ln P(w2|w1) * lm_alpha; row V =
                                 # <s>, col V = </s>; all-zero when no LM
    beam_width: int,
    blank: int,
    blank_skip_threshold: float,
    n_frames: int | None = None,
    return_scores: bool = False,
):
    """-> (best prefixes (B, T) int64, their lengths (B,) int64), on
    log_probs' device, and with `return_scores` the best beams' normalised
    scores (B,) float32.  `n_frames` bounds the loop: frames from there on
    must lie past every row's length (they would be skipped anyway)."""
    B, T, C = log_probs.shape
    K = beam_width
    V = lm_matrix.shape[0] - 1  # sentinel index for empty history / EOS
    dev = log_probs.device
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(NEG_INF, **f32)

    # initial state: beam 0 = empty prefix, rest invalid
    prefixes = torch.zeros((B, K, T), **i64)
    lens = torch.zeros((B, K), **i64)
    last = torch.full((B, K), V, **i64)
    h0 = torch.cat([torch.ones(1, **i32), -2 - torch.arange(K - 1, **i32)])
    h1 = h0.expand(B, K).clone()
    h2 = h0.expand(B, K).clone()
    p_b = torch.full((B, K), NEG_INF, **f32)
    p_b[:, 0] = 0.0
    p_nb = torch.full((B, K), NEG_INF, **f32)

    # per-frame gates, for all frames at once
    lp_blank = log_probs[:, :, blank]                              # (B, T)
    frames = torch.arange(T, **i64)
    # skip blank-dominated and padded frames: the whole state holds
    skip_all = (((1.0 - torch.exp(lp_blank)) < blank_skip_threshold)
                | (frames[None, :] >= lengths.to(dev)[:, None]))
    prev_lp_blank = torch.cat(
        [torch.full((B, 1), NEG_INF, **f32), lp_blank[:, :-1]], dim=1)
    prev_dominant_all = prev_lp_blank >= math.log(0.9)             # (B, T)

    labels = torch.arange(C, **i64)
    labels32 = labels.to(torch.int32)
    slots = torch.arange(T, **i64)

    for t in range(T if n_frames is None else min(T, n_frames)):
        lp_t = log_probs[:, t]                                     # (B, C)
        p_total = torch.logaddexp(p_b, p_nb)                       # (B, K)

        # ---- candidate construction: K "stay" + K*C "extend" ----
        # stay: same prefix; the blank path collects everything, the
        # non-blank path continues the trailing label
        stay_pb = p_total + lp_t[:, blank, None]
        lp_last = torch.gather(lp_t, 1, last.clamp(max=C - 1))
        stay_pnb = torch.where(lens > 0, p_nb + lp_last, neg_inf)

        # extensions: beam k extended with class c (c != blank)
        is_repeat = last[:, :, None] == labels                     # (B, K, C)
        via_blank = is_repeat & ~prev_dominant_all[:, t, None, None]
        base = torch.where(via_blank, p_b[:, :, None], p_total[:, :, None])
        lm_term = lm_matrix[last][:, :, :C]                        # (B, K, C)
        ext_pnb = base + lp_t[:, None, :] + lm_term
        ext_pnb[:, :, blank] = NEG_INF   # the blank column is no extension

        # extension hashes (the candidate prefix parent + [c])
        ch1 = (h1[:, :, None] * _MUL1 + labels32 + 1).reshape(B, K * C)
        ch2 = (h2[:, :, None] * _MUL2 + labels32 + 1).reshape(B, K * C)

        # ---- structural merge: extension -> stay collisions only ----
        m = ((ch1[:, :, None] == h1[:, None, :])
             & (ch2[:, :, None] == h2[:, None, :]))                # (B, KC, K)
        ext_flat = ext_pnb.reshape(B, K * C)
        # masked log-sum-exp; a column with no collision gives -inf, and
        # logaddexp(x, -inf) = x
        stay_gain = torch.logsumexp(
            torch.where(m, ext_flat[:, :, None],
                        torch.tensor(-math.inf, **f32)), dim=1)    # (B, K)
        stay_pnb = torch.logaddexp(stay_pnb, stay_gain)
        ext_flat = torch.where(m.any(dim=2), neg_inf, ext_flat)

        # ---- the K best of the (pairwise-distinct) candidates ----
        cand_total = torch.cat(
            [torch.logaddexp(stay_pb, stay_pnb), ext_flat], dim=1)
        top_pos = torch.sort(cand_total, dim=1, descending=True,
                             stable=True).indices[:, :K]           # (B, K)
        is_stay = top_pos < K
        j = torch.where(is_stay, top_pos, 0)                       # stay index
        e = torch.where(is_stay, 0, top_pos - K)                   # ext index
        sel_parent = torch.where(is_stay, j, e // C)
        sel_label = e % C
        sel_ext = ~is_stay

        parent_lens = torch.gather(lens, 1, sel_parent)
        new_prefixes = torch.gather(
            prefixes, 1, sel_parent[:, :, None].expand(B, K, T))
        put = parent_lens.clamp(0, T - 1)
        new_prefixes = torch.where(
            sel_ext[:, :, None] & (slots == put[:, :, None]),
            sel_label[:, :, None], new_prefixes)
        new_lens = parent_lens + sel_ext.to(torch.int64)
        new_last = torch.where(sel_ext, sel_label,
                               torch.gather(last, 1, sel_parent))
        new_h1 = torch.where(is_stay, torch.gather(h1, 1, j),
                             torch.gather(ch1, 1, e))
        new_h2 = torch.where(is_stay, torch.gather(h2, 1, j),
                             torch.gather(ch2, 1, e))
        new_pb = torch.where(is_stay, torch.gather(stay_pb, 1, j), neg_inf)
        new_pnb = torch.where(is_stay, torch.gather(stay_pnb, 1, j),
                              torch.gather(ext_flat, 1, e))

        # ---- frame gating, per batch row ----
        hold = skip_all[:, t, None]                                # (B, 1)
        prefixes = torch.where(hold[:, :, None], prefixes, new_prefixes)
        lens = torch.where(hold, lens, new_lens)
        last = torch.where(hold, last, new_last)
        h1 = torch.where(hold, h1, new_h1)
        h2 = torch.where(hold, h2, new_h2)
        p_b = torch.where(hold, p_b, new_pb)
        p_nb = torch.where(hold, p_nb, new_pnb)

    # ---- finalize: EOS LM term + length normalization ----
    p_total = torch.logaddexp(p_b, p_nb)
    eos = torch.where(lens > 0, lm_matrix[last, V],
                      torch.zeros((), **f32))
    norm = (p_total + eos) / lens.clamp(min=1)
    best = torch.argmax(norm, dim=1)                               # first max
    best_prefix = torch.gather(
        prefixes, 1, best[:, None, None].expand(B, 1, T))[:, 0]
    best_len = torch.gather(lens, 1, best[:, None])[:, 0]
    if return_scores:
        score = torch.gather(norm, 1, best[:, None])[:, 0]
        return best_prefix, best_len, score
    return best_prefix, best_len


def beam_search(log_probs: torch.Tensor, lengths: torch.Tensor,
                lm_matrix: torch.Tensor, beam_width: int, blank: int,
                blank_skip_threshold: float, n_frames: int | None = None):
    """beam_search_batch's result: the kernel on CUDA tensors (one launch;
    it bounds each row's loop by its own length, so `n_frames` is for the
    plain version), the plain version on CPU tensors."""
    if log_probs.device.type == "cpu":
        return beam_search_batch(log_probs, lengths, lm_matrix, beam_width,
                                 blank, blank_skip_threshold, n_frames)
    return ctc_beam_kernel(log_probs.contiguous(), lengths, lm_matrix,
                           beam_width, blank, blank_skip_threshold)


class BatchedBeamDecoder:
    """Drop-in batched replacement for decode.beam.BeamSearchDecoder.

    `device`: where probabilities that arrive as numpy arrays are decoded;
    a tensor is decoded on the device it lies on."""

    def __init__(
        self,
        id2word: Dict[int, str],
        beam_width: int = 10,
        blank: int = 0,
        lm=None,
        lm_alpha: float = 0.0,
        blank_skip_threshold: float = 0.1,
        device: str | torch.device = "cuda",
    ):
        self.id2word = id2word
        self.beam_width = beam_width
        self.blank = blank
        self.blank_skip_threshold = blank_skip_threshold
        self.device = torch.device(device)
        v = max(id2word.keys()) + 1
        if lm is not None and lm_alpha != 0.0:
            self.lm_matrix = torch.from_numpy(np.asarray(
                lm.dense_matrix(id2word) * lm_alpha, np.float32))
        else:
            self.lm_matrix = torch.zeros((v + 1, v + 1), dtype=torch.float32)
        self.lm_matrix = self.lm_matrix.to(self.device)

    def _on_device(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.float()
        return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)

    def decode(self, probs, lengths: Sequence[int]) -> List[List[int]]:
        """(B, T, C) probabilities -> label id sequences."""
        return self.decode_log(
            torch.log(self._on_device(probs).clamp_min(1e-38)), lengths)

    def decode_log(self, log_probs, lengths: Sequence[int]) -> List[List[int]]:
        """(B, T, C) LOG probabilities -> label id sequences.

        The model's log-softmax output is fed straight in, on its device
        (the search derives p(blank) for the skip and repeat gates from
        the log values itself)."""
        lp = self._on_device(log_probs)
        if self.lm_matrix.device != lp.device:
            self.lm_matrix = self.lm_matrix.to(lp.device)
        host_lengths = np.asarray(lengths, np.int64).reshape(-1)
        prefixes, lens = beam_search(
            lp, torch.from_numpy(host_lengths).to(lp.device), self.lm_matrix,
            beam_width=self.beam_width, blank=self.blank,
            blank_skip_threshold=self.blank_skip_threshold,
            n_frames=int(host_lengths.max(initial=0)))
        prefixes = prefixes.cpu().numpy()
        lens = lens.cpu().numpy()
        return [prefixes[b, : lens[b]].tolist()
                for b in range(prefixes.shape[0])]

    def decode_phones(self, probs, lengths) -> List[List[str]]:
        return [[self.id2word[i] for i in seq]
                for seq in self.decode(probs, lengths)]
