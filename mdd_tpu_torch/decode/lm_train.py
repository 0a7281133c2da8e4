"""Bigram phone-LM trainer: counts -> Witten-Bell backoff -> ARPA
(counterpart of mdd_tpu/decode/lm_train.py; host only).

Replaces the reference's IRSTLM pipeline (steps/train_lm.sh:18-23:
add-start-end.sh | build-lm.sh | compile-lm --text) at this corpus's
trivial scale (44 unigrams / ~1.5k bigrams in the committed
data/lm_phone_bg.arpa).  Witten-Bell interpolated smoothing matches
build-lm.sh's default; the emitted ARPA loads with our ArpaBigramLM
(decode/arpa.py) and with the reference's NgramLM parser (tab-separated
log10 fields).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

LOG10_ZERO = -99.0


class BigramCounts:
    def __init__(self, start: str = "<s>", end: str = "</s>"):
        self.start, self.end = start, end
        self.uni: Counter = Counter()
        self.bi: Counter = Counter()
        self.successors: Dict[str, set] = defaultdict(set)

    def add_sentence(self, tokens: Sequence[str]) -> None:
        seq = [self.start, *tokens, self.end]
        for w in seq:
            self.uni[w] += 1
        for a, b in zip(seq, seq[1:]):
            self.bi[(a, b)] += 1
            self.successors[a].add(b)

    def add_corpus(self, sentences: Iterable[Sequence[str]]) -> None:
        for s in sentences:
            self.add_sentence(s)


def witten_bell_bigram(
    counts: BigramCounts,
) -> Tuple[Dict[str, Tuple[float, float]], Dict[Tuple[str, str], float]]:
    """-> (unigrams {w: (log10 p, log10 bow)}, bigrams {(w1,w2): log10 p}).

    Interpolated Witten-Bell: each history w1 reserves T(w1)/(c(w1)+T(w1))
    mass for unseen successors, redistributed proportionally to the
    unigram distribution; the backoff weight makes the model sum to one.
    """
    total = sum(c for w, c in counts.uni.items() if w != counts.start)
    vocab = [w for w in counts.uni if w != counts.start]
    # Witten-Bell at the unigram level too: the distinct-type count
    # reserves mass for <unk> (the committed IRSTLM artifact carries an
    # <unk> unigram as well — data/lm_phone_bg.arpa has 44 unigrams for
    # 41 phones).  The start symbol gets the conventional -99 placeholder.
    n_types = len(vocab)
    p_uni = {w: counts.uni[w] / (total + n_types) for w in vocab}
    p_uni["<unk>"] = n_types / (total + n_types)

    unigrams: Dict[str, Tuple[float, float]] = {}
    bigrams: Dict[Tuple[str, str], float] = {}

    histories = [w for w in counts.uni if w != counts.end]
    for w1 in counts.uni:
        if w1 in counts.successors:
            c1 = sum(counts.bi[(w1, w2)] for w2 in counts.successors[w1])
            t1 = len(counts.successors[w1])
            lam = t1 / (c1 + t1)
            # With interpolated WB, the leftover mass for unseen successors
            # is exactly lam * (1 - sum_seen p_uni), so the ARPA backoff
            # weight is simply lam.
            bow = lam
            for w2 in counts.successors[w1]:
                p = ((1.0 - lam) * counts.bi[(w1, w2)] / c1
                     + lam * p_uni.get(w2, 0.0))
                bigrams[(w1, w2)] = math.log10(p)
        else:
            bow = 1.0
        log_p = (LOG10_ZERO if w1 == counts.start
                 else math.log10(p_uni[w1]))
        unigrams[w1] = (log_p, math.log10(bow) if bow > 0 else LOG10_ZERO)
    unigrams["<unk>"] = (math.log10(p_uni["<unk>"]), 0.0)
    return unigrams, bigrams


def write_arpa(
    unigrams: Dict[str, Tuple[float, float]],
    bigrams: Dict[Tuple[str, str], float],
    path: str,
) -> None:
    """Emit a standard ARPA file (tab-separated, log10)."""
    with open(path, "w", encoding="utf-8") as f:
        f.write("\\data\\\n")
        f.write(f"ngram 1= {len(unigrams)}\n")
        f.write(f"ngram 2= {len(bigrams)}\n")
        f.write("\n\\1-grams:\n")
        for w in sorted(unigrams):
            p, bow = unigrams[w]
            f.write(f"{p:.6f}\t{w}\t{bow:.6f}\n")
        f.write("\n\\2-grams:\n")
        for (w1, w2) in sorted(bigrams):
            f.write(f"{bigrams[(w1, w2)]:.6f}\t{w1} {w2}\n")
        f.write("\n\\end\\\n")


def train_phone_lm(phn_text_path: str, arpa_out: str) -> int:
    """Train the bigram phone LM from a Kaldi-style phn_text file
    (train_lm.sh replacement).  Returns the number of sentences."""
    counts = BigramCounts()
    n = 0
    with open(phn_text_path, "r", encoding="utf-8") as f:
        for line in f:
            toks = line.strip().split(" ")[1:]
            if toks:
                counts.add_sentence(toks)
                n += 1
    unigrams, bigrams = witten_bell_bigram(counts)
    write_arpa(unigrams, bigrams, arpa_out)
    return n
