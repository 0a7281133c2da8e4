"""Phone vocabulary with reference-compatible id assignment (counterpart
of mdd_tpu/data/vocab.py).

Ids: {blank: 0, UNK: 1}, then phones in first-seen order — identical to the
reference Vocab (egs/attention_aug/utils/data_loader.py:13-52) so that
checkpoints/targets trained against a given `units` file agree.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

BLANK = "blank"
UNK = "UNK"
BLANK_ID = 0
UNK_ID = 1


class Vocab:
    def __init__(self, units: Iterable[str] = ()):
        self.word2index = {BLANK: BLANK_ID, UNK: UNK_ID}
        self.index2word = {BLANK_ID: BLANK, UNK_ID: UNK}
        self.word2count: dict = {}
        self.n_words = 2
        for u in units:
            self.add_word(u)

    @classmethod
    def from_units_file(cls, path: str) -> "Vocab":
        """Build from a `units` file: one phone per line (possibly with a
        leading id column, which is ignored like the reference's
        add_sentence on multi-field lines)."""
        vocab = cls()
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                fields = line.strip().split(" ")
                if not fields or fields == [""]:
                    continue
                tokens = fields[1:] if len(fields) > 1 else fields
                for t in tokens:
                    vocab.add_word(t)
        return vocab

    @classmethod
    def from_label_file(cls, path: str) -> "Vocab":
        """Build by scanning a training `phn_text` (uttid phones...) file —
        the semantics of steps/get_model_units.py + Vocab combined."""
        vocab = cls()
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                fields = line.strip().split(" ")
                for t in fields[1:]:
                    vocab.add_word(t)
        return vocab

    def add_word(self, word: str) -> None:
        if word not in self.word2index:
            self.word2index[word] = self.n_words
            self.index2word[self.n_words] = word
            self.word2count[word] = 1
            self.n_words += 1
        else:
            self.word2count[word] += 1

    def encode(self, phones: Sequence[str]) -> List[int]:
        return [self.word2index.get(p, UNK_ID) for p in phones]

    def encode_array(self, phones: Sequence[str]) -> np.ndarray:
        return np.asarray(self.encode(phones), dtype=np.int32)

    def decode(self, ids: Sequence[int]) -> List[str]:
        return [self.index2word[int(i)] for i in ids]

    def units(self) -> List[str]:
        """The phone list excluding blank/UNK, in id order."""
        return [self.index2word[i] for i in range(2, self.n_words)]

    def save_units(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for u in self.units():
                f.write(u + "\n")
