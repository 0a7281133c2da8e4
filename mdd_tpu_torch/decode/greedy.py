"""Greedy (best-path) CTC decoding (counterpart of mdd_tpu/decode/greedy.py).

The framewise argmax runs on the device; the collapse (drop repeats,
then blanks) runs on the host, where the ragged outputs are consumed.
`collapse_ctc` keeps the reference's compute_wer semantics
(model_ctc.compute_wer:227-244).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def best_path(log_probs: torch.Tensor) -> np.ndarray:
    """(T, B, C) log-probs -> (B, T) host array of framewise argmax ids."""
    return log_probs.argmax(dim=-1).transpose(0, 1).cpu().numpy()


def collapse_ctc(ids: np.ndarray, length: int, blank: int = 0) -> List[int]:
    """Collapse one framewise id sequence (reference compute_wer semantics)."""
    out: List[int] = []
    for j in range(min(length, len(ids))):
        if ids[j] == blank:
            continue
        if j == 0:
            out.append(int(ids[j]))
        elif ids[j] != ids[j - 1]:
            out.append(int(ids[j]))
    return out


def greedy_decode(log_probs, lengths) -> List[List[int]]:
    """(T, B, C) log-probs (a tensor, on its device, or an array) + (B,)
    frame counts -> list of id sequences."""
    ids = best_path(torch.as_tensor(log_probs))
    return [collapse_ctc(ids[b], int(lengths[b])) for b in range(ids.shape[0])]
