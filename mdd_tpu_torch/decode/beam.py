"""CTC prefix beam search with bigram LM fusion — host reference decoder
(counterpart of mdd_tpu/decode/beam.py; float64 on the host).

Algorithm-for-algorithm redesign of the reference beam search
(utils/BeamSearch.py:35-153), operating on (T, C) probability matrices:

  * per-prefix blank / non-blank log probabilities;
  * blank-dominated frame skipping (`1 - p(blank) < 0.1` -> skip frame);
  * bigram LM fusion on prefix extension, weighted by lm_alpha, with the
    repeat-vs-blank disambiguation (`p_{t-1}(blank) < 0.9` gate);
  * end-of-sequence LM term and length normalization before the final sort.

This implementation is the semantic ground truth the batched device beam
search (decode/beam_jit.py) is tested against.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from mdd_tpu_torch.decode.arpa import ArpaBigramLM, UniformLM

LOG_ZERO = -1e30


def _log_add(x: float, y: float) -> float:
    if x <= LOG_ZERO:
        return y
    if y <= LOG_ZERO:
        return x
    if y > x:
        x, y = y, x
    return x + math.log1p(math.exp(y - x))


class _Entry:
    __slots__ = ("p_total", "p_nonblank", "p_blank")

    def __init__(self):
        self.p_total = LOG_ZERO
        self.p_nonblank = LOG_ZERO
        self.p_blank = LOG_ZERO


class BeamSearchDecoder:
    def __init__(
        self,
        id2word: Dict[int, str],
        beam_width: int = 10,
        blank: int = 0,
        lm: ArpaBigramLM | None = None,
        lm_alpha: float = 0.0,
        blank_skip_threshold: float = 0.1,
    ):
        self.id2word = id2word
        self.beam_width = beam_width
        self.blank = blank
        self.lm = lm if lm is not None else UniformLM()
        self.lm_alpha = lm_alpha
        self.blank_skip_threshold = blank_skip_threshold

    def _lm_bigram(self, prefix: Tuple[int, ...], k: int) -> float:
        if self.lm_alpha == 0.0:
            return 0.0
        w1 = self.id2word[prefix[-1]] if prefix else ""
        return self.lm.bi_prob(w1, self.id2word[k]) * self.lm_alpha

    def decode_single(self, probs: np.ndarray, length: int) -> List[int]:
        """(T, C) probabilities -> best label sequence (ids)."""
        log_probs = np.log(np.maximum(probs, 1e-38))
        last: Dict[Tuple[int, ...], _Entry] = {}
        root = _Entry()
        root.p_blank = 0.0
        root.p_total = 0.0
        last[()] = root
        n_class = probs.shape[1]

        for t in range(length):
            if (1.0 - probs[t, self.blank]) < self.blank_skip_threshold:
                continue
            best = sorted(last.items(), key=lambda kv: kv[1].p_total,
                          reverse=True)[: self.beam_width]
            curr: Dict[Tuple[int, ...], _Entry] = {}
            lp_t = log_probs[t]
            for y, ent in best:
                # keep prefix: emit blank, or repeat last label
                p_nonblank = LOG_ZERO
                if y:
                    p_nonblank = ent.p_nonblank + lp_t[y[-1]]
                p_blank = ent.p_total + lp_t[self.blank]
                e = curr.get(y)
                if e is None:
                    e = curr[y] = _Entry()
                e.p_nonblank = _log_add(e.p_nonblank, p_nonblank)
                e.p_blank = _log_add(e.p_blank, p_blank)
                e.p_total = _log_add(e.p_total,
                                     _log_add(p_blank, p_nonblank))

                # extend prefix with every non-blank label
                prev_blank_dominant = (
                    t > 0 and probs[t - 1, self.blank] >= 0.9)
                for k in range(n_class):
                    if k == self.blank:
                        continue
                    lm_term = self._lm_bigram(y, k)
                    if y and y[-1] == k and not prev_blank_dominant:
                        # repeat only via the blank path
                        p_ext = lp_t[k] + lm_term + ent.p_blank
                    else:
                        p_ext = lp_t[k] + lm_term + ent.p_total
                    new_y = y + (k,)
                    e2 = curr.get(new_y)
                    if e2 is None:
                        e2 = curr[new_y] = _Entry()
                    e2.p_nonblank = _log_add(e2.p_nonblank, p_ext)
                    e2.p_total = _log_add(e2.p_total, p_ext)
            if curr:
                last = curr

        # end-of-sequence LM term + length normalization
        best = sorted(last.items(), key=lambda kv: kv[1].p_total,
                      reverse=True)[: self.beam_width]
        final: List[Tuple[Tuple[int, ...], float]] = []
        for y, ent in best:
            p = ent.p_total
            if y and self.lm_alpha:
                p = p + self.lm.bi_prob(self.id2word[y[-1]], "") * self.lm_alpha
            norm = p / (len(y) if len(y) else 1)
            final.append((y, norm))
        final.sort(key=lambda kv: kv[1], reverse=True)
        return list(final[0][0]) if final else []

    def decode(self, probs: np.ndarray, lengths: Sequence[int]) -> List[List[int]]:
        """(B, T, C) or (T, B, C)->transposed upstream; probabilities."""
        return [self.decode_single(probs[b], int(lengths[b]))
                for b in range(probs.shape[0])]

    def decode_phones(self, probs: np.ndarray, lengths: Sequence[int]) -> List[List[str]]:
        return [[self.id2word[i] for i in seq]
                for seq in self.decode(probs, lengths)]
