"""ARPA bigram language model: loader, scorer, dense-matrix compiler
(counterpart of mdd_tpu/decode/arpa.py; host numpy).

Parses the ARPA files the reference consumes (utils/NgramLM.py:11-90
semantics: log10 -> natural log, unigram backoff weights, backoff bigram
probability) and additionally compiles the LM into a dense (V+2, V+2)
log-prob matrix over vocabulary ids for the batched device beam search —
bigram lookups become array indexing instead of dict probes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

LN10 = math.log(10.0)


class ArpaBigramLM:
    def __init__(self, arpa_file: Optional[str] = None,
                 start: str = "<s>", end: str = "</s>", unk: str = "<unk>"):
        self.start, self.end, self.unk = start, end, unk
        self.unigram: Dict[str, List[float]] = {}
        self.bigram: Dict[str, List[float]] = {}
        if arpa_file:
            self._load(arpa_file)

    def _load(self, path: str) -> None:
        recording = 0
        with open(path, "r", encoding="utf-8") as f:
            for raw in f:
                line = raw.rstrip("\n")
                if line == "\\1-grams:":
                    recording = 1
                    continue
                if line == "\\2-grams:":
                    recording = 2
                    continue
                if line.startswith("\\end"):
                    break
                fields = line.split("\t")
                if recording == 1:
                    if len(fields) == 3:
                        self.unigram[fields[1]] = [LN10 * float(fields[0]),
                                                   LN10 * float(fields[2])]
                    elif len(fields) == 2:
                        self.unigram[fields[1]] = [LN10 * float(fields[0]), 0.0]
                elif recording == 2:
                    if len(fields) == 3:
                        self.bigram[fields[1]] = [LN10 * float(fields[0]),
                                                  LN10 * float(fields[2])]
                    elif len(fields) == 2:
                        self.bigram[fields[1]] = [LN10 * float(fields[0]), 0.0]
        if self.unk in self.unigram:
            self.unigram["UNK"] = self.unigram[self.unk]

    def uni_prob(self, w: str) -> float:
        return self.unigram[w][0]

    def bi_prob(self, w1: str, w2: str) -> float:
        """ln P(w2|w1) with unigram backoff (NgramLM.get_bi_prob:65-78)."""
        if w1 == "":
            w1 = self.start
        if w2 == "":
            w2 = self.end
        key = w1 + " " + w2
        if key not in self.bigram:
            return self.unigram[w1][1] + self.unigram[w2][0]
        return self.bigram[key][0]

    def score_sentence(self, words: Sequence[str]) -> float:
        val = self.bi_prob(self.start, words[0])
        for a, b in zip(words, words[1:]):
            val += self.bi_prob(a, b)
        val += self.bi_prob(words[-1], self.end)
        return val

    def dense_matrix(self, id2word: Dict[int, str]) -> np.ndarray:
        """Compile ln P(w2|w1) into a dense matrix over vocab ids.

        Rows/cols 0..V-1 are vocabulary ids (words missing from the LM get
        -inf-ish mass via their absence — we fall back to a large negative);
        row V is <s> (empty history), column V is </s> (end of sequence).
        """
        v = max(id2word.keys()) + 1
        mat = np.full((v + 1, v + 1), -1e30, dtype=np.float32)

        def word(i: int) -> str:
            return self.start if i == v else id2word.get(i, "")

        for i in range(v + 1):
            w1 = word(i)
            if w1 not in self.unigram:
                continue
            for j in range(v + 1):
                w2 = self.end if j == v else id2word.get(j, "")
                if w2 not in self.unigram and w2 != self.end:
                    continue
                try:
                    mat[i, j] = self.bi_prob(w1, w2)
                except KeyError:
                    pass
        return mat


class UniformLM(ArpaBigramLM):
    """A no-op LM (all log-probs zero): used when lm_alpha == 0 or no ARPA
    file is configured — keeps the beam-search code path uniform."""

    def __init__(self):
        super().__init__(None)

    def bi_prob(self, w1: str, w2: str) -> float:
        return 0.0

    def dense_matrix(self, id2word: Dict[int, str]) -> np.ndarray:
        v = max(id2word.keys()) + 1
        return np.zeros((v + 1, v + 1), dtype=np.float32)
