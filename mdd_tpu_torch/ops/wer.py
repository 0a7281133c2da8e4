"""Greedy train-WER on the device: batched CTC collapse + Levenshtein DP
(counterpart of mdd_tpu/ops/wer.py).

The training step reports word (phone) errors and reference tokens as two
device scalars, so the loop never copies the (B, T') argmax ids to the
host:

  * collapse: keep = non-blank & != previous frame id (decode/greedy's
    collapse_ctc), compacted into a dense (B, T) token array by a scatter
    to cumsum positions;
  * edit distance: one loop over predicted positions carrying the
    (B, L+1) DP row; the insertion chain along the row,
    new[j] = min(c[j], new[j-1] + 1), is cummin(c[k] - k) + j;
  * per-row distances are read at each row's true label length, masked
    by batch validity and summed.
"""

from __future__ import annotations

import torch


def batched_edit_distance(pred: torch.Tensor, pred_len: torch.Tensor,
                          targets: torch.Tensor,
                          target_sizes: torch.Tensor) -> torch.Tensor:
    """Levenshtein distance per row.

    pred: (B, T) token ids, valid prefix per pred_len; targets: (B, L)
    with valid prefix per target_sizes.  -> (B,) int64 distances."""
    b, t = pred.shape
    l = targets.shape[1]
    jrange = torch.arange(l + 1, device=pred.device)
    row = jrange.expand(b, l + 1)
    targets = targets.long()
    for step in range(t):
        cost = (targets != pred[:, step, None]).long()          # (B, L)
        cand = torch.minimum(row[:, 1:] + 1, row[:, :-1] + cost)
        c = torch.cat([row[:, :1] + 1, cand], dim=1)            # (B, L+1)
        new = torch.cummin(c - jrange, dim=1).values + jrange
        row = torch.where((step < pred_len)[:, None], new, row)
    return row.gather(1, target_sizes.long()[:, None])[:, 0]


def greedy_wer_counts(ids: torch.Tensor, frames: torch.Tensor,
                      targets: torch.Tensor, target_sizes: torch.Tensor,
                      valid: torch.Tensor, blank: int = 0):
    """-> (errors, tokens) int64 device scalars over the valid rows.

    ids: (B, T) framewise argmax ids; frames: (B,) true frame counts;
    collapse semantics identical to decode/greedy.collapse_ctc."""
    b, t = ids.shape
    ids = ids.long()
    tvalid = torch.arange(t, device=ids.device)[None] < frames[:, None]
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    keep = tvalid & (ids != blank) & (ids != prev)
    pos = torch.cumsum(keep, dim=1) - 1
    pred_len = keep.sum(dim=1)
    # kept tokens to the row head; dropped ones land in a spare column
    scatter_pos = torch.where(keep, pos, torch.full_like(pos, t))
    pred = torch.zeros((b, t + 1), dtype=torch.long, device=ids.device)
    pred.scatter_(1, scatter_pos, ids)
    dist = batched_edit_distance(pred[:, :t], pred_len, targets,
                                 target_sizes)
    zero = torch.zeros((), dtype=torch.long, device=ids.device)
    errs = torch.where(valid, dist, zero).sum()
    tokens = torch.where(valid, target_sizes.long(), zero).sum()
    return errs, tokens
