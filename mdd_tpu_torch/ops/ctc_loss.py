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

`ctc_loss_scan` is mdd_tpu's plain version: the log-space alpha recursion
over the extended (blank-interleaved) labels, one step a frame, with
gradients from autograd (-posterior at the log-probs).  It is kept to
cross-check `ctc_loss`, as mdd_tpu keeps its own to cross-check its
custom VJP; no training path runs it.
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


def _logsumexp3(a, b, c):
    """log(e^a + e^b + e^c), LOG_EPS where all three are at the floor (the
    max is held constant, so the gradient is the softmax of the three)."""
    stacked = torch.stack([a, b, c])
    m = stacked.max(dim=0).values.detach()
    out = m + torch.log(torch.exp(stacked - m).sum(dim=0))
    return torch.where(m <= LOG_EPS / 2, torch.full_like(out, LOG_EPS), out)


def ctc_loss_scan(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                  labels: torch.Tensor, label_lengths: torch.Tensor,
                  blank: int = 0) -> torch.Tensor:
    """Per-sample negative log likelihood by the alpha recursion
    (mdd_tpu's `ctc_loss_scan`): the arguments of `ctc_loss`; -> (B,).
    A row no alignment fits has nll 1e30 (-LOG_EPS) and zero gradient."""
    t_max, b, _ = log_probs.shape
    dev = log_probs.device
    labels = labels.long()
    input_lengths = input_lengths.long().to(dev)
    label_lengths = label_lengths.long().to(dev)
    s = 2 * labels.shape[1] + 1
    ext = torch.full((b, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    pos = torch.arange(s, device=dev)[None, :]
    valid_s = pos < (2 * label_lengths[:, None] + 1)
    ext_m2 = F.pad(ext, (2, 0), value=blank)[:, :s]
    can_skip = (ext != blank) & (ext != ext_m2) & (pos >= 2)
    emit = log_probs.gather(2, ext[None].expand(t_max, b, s))   # (T, B, S)
    floor = torch.full((b, s), LOG_EPS, dtype=log_probs.dtype, device=dev)
    first = (pos == 0) | ((pos == 1) & (label_lengths[:, None] > 0))
    alpha = torch.where(first, emit[0], floor)
    for t in range(1, t_max):
        a_m1 = F.pad(alpha, (1, 0), value=LOG_EPS)[:, :s]
        a_m2 = F.pad(alpha, (2, 0), value=LOG_EPS)[:, :s]
        a_m2 = torch.where(can_skip, a_m2, floor)
        new = torch.where(valid_s, _logsumexp3(alpha, a_m1, a_m2) + emit[t],
                          floor)
        # a row whose input has ended keeps its alpha
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
    end = 2 * label_lengths
    last = alpha.gather(1, end[:, None])[:, 0]
    second = alpha.gather(1, (end - 1).clamp_min(0)[:, None])[:, 0]
    second = torch.where(end >= 1, second, torch.full_like(second, LOG_EPS))
    m = torch.maximum(last, second).detach()
    ll = m + torch.log(torch.exp(last - m) + torch.exp(second - m))
    ll = torch.where(m <= LOG_EPS / 2, torch.full_like(ll, LOG_EPS), ll)
    return -ll


def ctc_loss_sum_mean(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                      labels: torch.Tensor, label_lengths: torch.Tensor,
                      blank: int = 0) -> torch.Tensor:
    """sum-over-batch / batch_size — the reference's training objective
    (nn.CTCLoss(reduction='sum') / batch_size, train_ctc.py:72-74)."""
    nll = ctc_loss(log_probs, input_lengths, labels, label_lengths, blank)
    return nll.sum() / log_probs.shape[1]
