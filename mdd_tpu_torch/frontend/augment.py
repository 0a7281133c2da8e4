"""Training-time augmentation: SpecAugment and canonical-transcript
mutation (counterpart of mdd_tpu/frontend/augment.py, less its jax.random
SpecAugment, which no path of the port uses).

Mirrors the reference pipeline (utils/tools.py:229-255 spec_augment with
freq-para 2 / time-para 5, and :290-359 data_enhancement with four mutation
modes applied per-phone to the canonical transcript while training).  Host
NumPy with an explicit Generator: the same Generator gives the same draws
in the same order as mdd_tpu, so augmented batches are equal bit for bit.
The device-resident corpus draws the mask geometry on the host
(``sample_spec_augment_params``) and applies it to the gathered batch on
the device (``apply_spec_augment_masks``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.lexicon.phones import CONSONANTS, VOWELS

# Common learner-error substitution distribution (reference
# utils/tools.py:13-54): canonical phone -> plausible mispronunciations.
COMMON_INCORRECT = {
    "t": ["r", "l", "n", "ah", "z", "uw", "dh", "s", "th", "f", "sh", "p", "ch", "ae", "d", "eh", "k", "sil", "er", "v"],
    "ah": ["l", "z", "uw", "uh", "ao", "ay", "ih", "ae", "aa", "d", "eh", "ow", "iy", "sil", "ey", "aw", "er", "t", "b"],
    "v": ["k", "r", "w", "sil", "l", "s", "p", "f", "er", "b"],
    "iy": ["jh", "sil", "er", "ah", "ey", "uw", "ay", "ih", "aw", "y", "eh", "ow"],
    "l": ["r", "w", "sil", "n", "iy", "ah", "z", "f", "ih", "er", "t", "eh"],
    "r": ["w", "sil", "l", "n", "uh", "iy", "ah", "ao", "z", "ey", "aa", "ih", "er", "d"],
    "sil": ["r", "l", "n", "ah", "z", "uw", "dh", "w", "s", "uh", "ao", "f", "sh", "ih", "m", "y", "jh", "p", "ae", "aa", "ng", "d", "eh", "k", "iy", "hh", "g", "er", "v", "t", "b"],
    "dh": ["r", "hh", "sil", "l", "s", "n", "th", "p", "z", "y", "er", "d", "t", "eh"],
    "ae": ["sil", "ao", "ah", "ey", "ay", "aa", "ih", "aw", "t", "eh"],
    "ow": ["iy", "r", "sil", "w", "uh", "ao", "ah", "uw", "aa", "ih", "oy", "aw", "er"],
    "p": ["k", "sil", "f", "er", "v", "t", "b"],
    "er": ["iy", "r", "sil", "l", "w", "uh", "ao", "ah", "uw", "aa", "eh", "ow"],
    "d": ["r", "l", "n", "ah", "z", "dh", "s", "zh", "th", "f", "jh", "p", "ng", "eh", "k", "iy", "sil", "g", "er", "v", "t", "b"],
    "ch": ["jh", "sil", "zh", "s", "dh", "sh", "t"],
    "ih": ["iy", "r", "sil", "n", "uh", "ah", "ey", "ae", "ay", "aa", "uw", "er", "eh"],
    "s": ["k", "hh", "sil", "zh", "th", "z", "sh", "t"],
    "z": ["r", "jh", "sil", "s", "zh", "g", "th", "f", "dh", "sh", "er", "t"],
    "aa": ["sil", "ao", "ah", "ae", "uw", "aw", "er", "eh", "ow"],
    "g": ["k", "jh", "hh", "sil", "er", "d", "b"],
    "ng": ["sil", "n", "l", "uh", "m"],
    "n": ["hh", "sil", "l", "p", "z", "f", "ng", "m", "y", "v", "d"],
    "hh": ["k", "jh", "sil", "g", "er", "ch", "sh", "y", "t"],
    "jh": ["k", "sil", "zh", "s", "g", "ch", "sh", "y", "er", "d", "t"],
    "uh": ["ao", "ah", "uw", "ih", "er", "ow"],
    "eh": ["iy", "r", "sil", "ah", "ey", "ae", "ay", "aa", "uw", "ih", "er", "ow"],
    "uw": ["iy", "w", "sil", "l", "uh", "ah", "ao", "aa", "ih", "oy", "ow"],
    "ey": ["iy", "sil", "ah", "ae", "ay", "aa", "ih", "eh"],
    "b": ["r", "sil", "ah", "p", "f", "v", "t"],
    "k": ["hh", "w", "sil", "s", "g", "ch", "dh", "er", "t"],
    "aw": ["uh", "ao", "ah", "ay", "aa", "ow"],
    "ay": ["iy", "r", "sil", "ah", "ey", "ae", "aa", "ih", "oy", "eh"],
    "sh": ["sil", "zh", "s", "ch", "t"],
    "zh": ["jh", "s", "z", "ch", "sh"],
    "y": ["jh", "iy", "sil", "ih", "er"],
    "f": ["sil", "p", "er", "v", "b"],
    "th": ["sil", "s", "p", "z", "ch", "f", "er", "d", "t"],
    "ao": ["sil", "l", "uh", "ah", "uw", "ae", "aa", "aw", "er", "eh", "ow"],
    "m": ["ng", "sil", "n"],
    "w": ["hh", "sil", "l", "g", "r", "ao", "y", "v"],
    "oy": ["ao", "ow", "ay"],
}


def sample_spec_augment_params(
    t: int,
    v: int,
    rng: np.random.Generator,
    freq_mask_num: int = 1,
    time_mask_num: int = 1,
    freq_mask_para: int = 2,
    time_mask_para: int = 5,
) -> List[int]:
    """Draw the SpecAugment mask geometry, exactly the rng consumption of
    ``spec_augment``: [f, f0, ..., w, t0, ...], (width, start) per
    frequency mask then per time mask."""
    params: List[int] = []
    for _ in range(freq_mask_num):
        f = int(rng.uniform(0.0, freq_mask_para))
        params += [f, int(rng.integers(0, v - f + 1))]
    for _ in range(time_mask_num):
        w = int(rng.uniform(0.0, time_mask_para))
        params += [w, int(rng.integers(0, t - w + 1))]
    return params


def spec_augment(
    feats: np.ndarray,
    rng: np.random.Generator,
    freq_mask_num: int = 1,
    time_mask_num: int = 1,
    freq_mask_para: int = 2,
    time_mask_para: int = 5,
) -> np.ndarray:
    """Zero out random frequency columns / time rows (tools.py:229-255)."""
    t, v = feats.shape
    out = np.array(feats)
    params = sample_spec_augment_params(
        t, v, rng, freq_mask_num, time_mask_num,
        freq_mask_para, time_mask_para)
    for i in range(freq_mask_num):
        f, f0 = params[2 * i], params[2 * i + 1]
        out[:, f0:f0 + f] = 0
    for j in range(time_mask_num):
        w = params[2 * (freq_mask_num + j)]
        t0 = params[2 * (freq_mask_num + j) + 1]
        out[t0:t0 + w, :] = 0
    return out


def apply_spec_augment_masks(feats: torch.Tensor,
                             params: torch.Tensor) -> torch.Tensor:
    """Apply host-drawn SpecAugment geometry to a batch where it lies (the
    device-resident corpus's path).

    feats: (B, T, D); params: (B, 4) integer rows [f, f0, w, t0] from
    ``sample_spec_augment_params`` (one frequency and one time mask, the
    reference pipeline's default).  Zeroes feats[:, :, f0:f0+f] and
    feats[:, t0:t0+w, :] of each item, the entries ``spec_augment`` zeroes
    on the host, with the same +0.0; an all-zero row is a no-op.
    """
    _, t, d = feats.shape
    f, f0, w, t0 = (params[:, k, None] for k in range(4))
    col = torch.arange(d, device=feats.device)[None]
    row = torch.arange(t, device=feats.device)[None]
    fmask = (col >= f0) & (col < f0 + f)
    tmask = (row >= t0) & (row < t0 + w)
    return feats.masked_fill(fmask[:, None, :] | tmask[:, :, None], 0)


def mutate_transcript(
    phone_ids: Sequence[int],
    vocab: Vocab,
    rng: np.random.Generator,
    mutation_prob: float = 0.1,
    mode: int = 1,
) -> List[int]:
    """Per-phone canonical-transcript mutation (tools.data_enhancement).

    Modes: 1 vowel/consonant swap, 2 common-error distribution,
    3 uniform random shift, 4 zero-out (blank).
    """
    out = []
    n = vocab.n_words
    for pid in phone_ids:
        new = pid
        if rng.random() < mutation_prob:
            phone = vocab.index2word.get(pid)
            if mode == 1:
                for group in (VOWELS, CONSONANTS):
                    if phone in group:
                        cands = [p for p in group if p in vocab.word2index]
                        new = vocab.word2index[
                            cands[rng.integers(len(cands))]]
                        break
            elif mode == 2:
                if phone in COMMON_INCORRECT:
                    cands = [p for p in COMMON_INCORRECT[phone]
                             if p in vocab.word2index]
                    if cands:
                        new = vocab.word2index[
                            cands[rng.integers(len(cands))]]
            elif mode == 3:
                new = int((pid + rng.integers(0, n + 1)) % n)
            elif mode == 4:
                new = 0
        out.append(int(new))
    return out
