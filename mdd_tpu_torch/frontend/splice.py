"""Context splicing, frame skipping and downsample padding (counterpart of
mdd_tpu/frontend/splice.py): numpy on the host, and `batched_splice_skip`
in torch on the device for the training step's device front end.

Semantics mirror the reference data pipeline (utils/tools.py:207-227 and
utils/data_loader.py:138-142): splice left/right context with edge
replication, keep every k-th frame, and pad the time axis to a multiple
of the model's time downsampling factor.
"""

from __future__ import annotations

import numpy as np
import torch


def make_context(feature, left: int, right: int):
    """(T, D) -> (T, (left+1+right)*D) with edge-replicated shifts.

    Column order matches the reference: [left_k..left_1, x, right_1..right_k].
    """
    if left == 0 and right == 0:
        return feature
    t = feature.shape[0]
    idx = np.arange(t)
    cols = []
    for k in range(left, 0, -1):
        cols.append(feature[np.maximum(idx - k, 0)])
    cols.append(feature)
    for k in range(1, right + 1):
        cols.append(feature[np.minimum(idx + k, t - 1)])
    return np.concatenate(cols, axis=1)


def skip_frames(feature, skip: int):
    """Keep frames 0, skip, 2*skip, ... (reference skip_feat:218-227)."""
    if skip in (0, 1):
        return feature
    return feature[::skip]


def pad_to_multiple(feature, multiple: int):
    """Zero-pad the time axis so T % multiple == 0."""
    t = feature.shape[0]
    rem = t % multiple
    if rem == 0:
        return feature
    pad = multiple - rem
    widths = [(0, pad)] + [(0, 0)] * (feature.ndim - 1)
    return np.pad(feature, widths)


def output_frames(t_in: int, skip: int, multiple: int) -> int:
    """Frame count after skip + pad (the dataset-side length bookkeeping)."""
    t = (t_in + skip - 1) // skip if skip > 1 else t_in
    rem = t % multiple
    return t + (multiple - rem if rem else 0)


def batched_splice_skip(raw: torch.Tensor, lengths: torch.Tensor, left: int,
                        right: int, skip: int, multiple: int):
    """Splice + frame-skip of a zero-padded raw (B, T_raw, D) batch on its
    device, bit for bit what the host `make_context` -> `skip_frames` ->
    `pad_to_multiple` -> zero-padded batching gives, in raw's dtype
    (clamped edge replication per item, zeros past each item's length).

    T_raw must be divisible by skip * multiple (the loader's raw-grid
    bucket quantum guarantees it).  Returns (spliced (B, T_raw // skip,
    C * D), model_frames (B,) int64: the post-skip-and-pad frame counts)."""
    b, t_raw, d = raw.shape
    skip = max(skip, 1)
    if t_raw % (skip * multiple):
        raise ValueError(f"raw length {t_raw} is not a multiple of skip "
                         f"{skip} x downsample {multiple}")
    t_out = t_raw // skip
    base = torch.arange(t_out, device=raw.device) * skip        # (t_out,)
    len_b = lengths.long()[:, None]                             # (B, 1)
    cols = [torch.clamp(base - k, min=0).expand(b, t_out)
            for k in range(left, 0, -1)]
    cols.append(base.expand(b, t_out))
    cols += [torch.minimum(base[None] + k, len_b - 1)
             for k in range(1, right + 1)]
    n_ctx = len(cols)
    idx = torch.stack(cols, dim=2).clamp(0, t_raw - 1)          # (B, t_out, C)
    gathered = torch.gather(
        raw, 1, idx.reshape(b, t_out * n_ctx, 1).expand(-1, -1, d))
    spliced = gathered.reshape(b, t_out, n_ctx * d)
    valid = base[None] < len_b                                  # (B, t_out)
    spliced = spliced * valid[..., None].to(raw.dtype)
    n = (lengths.long() + skip - 1) // skip
    model_frames = (n + multiple - 1) // multiple * multiple
    return spliced, model_frames
