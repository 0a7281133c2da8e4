"""CTC loss (counterpart of mdd_tpu/ops/ctc_loss.py).

torch.nn.functional.ctc_loss computes the same per-sample negative log
likelihood as mdd_tpu's alpha-beta recursion; this is not a Pallas kernel,
so PyTorch's operator carries it.  Two conventions differ and are matched:

  * a row no alignment can fit (fewer frames than labels plus repeats)
    has nll = 1e30 (-LOG_EPS) and zero gradient in mdd_tpu; here
    `zero_infinity` gives 0 and zero gradient, and a detached 1e30 is
    added back on those rows;
  * F.ctc_loss's backward returns exp(log_probs) - posterior, the
    gradient at the logits of a log_softmax, where mdd_tpu returns
    -posterior at the log-probs; the two agree at the logits, which is
    where the model's gradient is taken.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LOG_EPS = -1e30


def infeasible(labels: torch.Tensor, input_lengths: torch.Tensor,
               label_lengths: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the rows whose labels need more frames than they have
    (one per label plus one blank between each repeated pair)."""
    pos = torch.arange(1, labels.shape[1], device=labels.device)
    repeats = ((labels[:, 1:] == labels[:, :-1])
               & (pos[None] < label_lengths[:, None])).sum(1)
    return input_lengths < label_lengths + repeats


def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Per-sample negative log likelihood.

    log_probs: (T, B, C) log-softmax outputs; input_lengths: (B,) valid
    frame counts (<= T); labels: (B, L) zero-padded ids; label_lengths:
    (B,) valid label counts.  -> (B,) float32."""
    input_lengths = input_lengths.long()
    label_lengths = label_lengths.long()
    nll = F.ctc_loss(log_probs, labels.long(), input_lengths, label_lengths,
                     blank=blank, reduction="none", zero_infinity=True)
    bad = infeasible(labels.long(), input_lengths, label_lengths)
    return nll + (-LOG_EPS) * bad.to(nll.dtype)


def ctc_loss_sum_mean(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                      labels: torch.Tensor, label_lengths: torch.Tensor,
                      blank: int = 0) -> torch.Tensor:
    """sum-over-batch / batch_size — the reference's training objective
    (nn.CTCLoss(reduction='sum') / batch_size, train_ctc.py:72-74)."""
    nll = ctc_loss(log_probs, input_lengths, labels, label_lengths, blank)
    return nll.sum() / log_probs.shape[1]
