"""CTC loss (counterpart of mdd_tpu/ops/ctc_loss.py).

`ctc_loss` is mdd_tpu's custom-VJP loss: the log-space alpha recursion
over the extended (blank-interleaved) labels gives the per-sample negative
log likelihood, and the backward, a reverse beta recursion, returns
-posterior at the log-probs (Graves 2006, eq. 7.31) times the incoming
cotangent.  A row no alignment can fit has nll = 1e30 (-LOG_EPS) and zero
gradient; a row of input length 0 still counts frame 0's emission, as
mdd_tpu's alpha0 does.  On CUDA tensors both recursions are the kernels
of csrc/ctc_loss.cu (`ctc_alpha`, `ctc_beta_grad`), which raise for what
they do not take; on CPU tensors they are the plain versions beside them
in ops/ctc_cuda.py.  Nothing falls back from one to the other.

`ctc_loss_scan` is mdd_tpu's plain version: the same alpha recursion, one
step a frame, with gradients from autograd.  It is kept to cross-check
`ctc_loss`, as mdd_tpu keeps its own to cross-check its custom VJP; no
training path runs it.
"""

from __future__ import annotations

import torch

from mdd_tpu_torch.ops import ctc_cuda
from mdd_tpu_torch.ops.ctc_cuda import CtcLoss, ctc_loss_fwd_reference

LOG_EPS = ctc_cuda.LOG_EPS


def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Per-sample negative log likelihood.

    log_probs: (T, B, C) float32 log-softmax outputs; input_lengths: (B,)
    valid frame counts (<= T); labels: (B, L) zero-padded ids;
    label_lengths: (B,) valid label counts, all on log_probs' device.
    -> (B,) float32."""
    return CtcLoss.apply(log_probs, input_lengths.long(), labels.long(),
                         label_lengths.long(), int(blank))


def ctc_loss_scan(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                  labels: torch.Tensor, label_lengths: torch.Tensor,
                  blank: int = 0) -> torch.Tensor:
    """Per-sample negative log likelihood by the alpha recursion
    (mdd_tpu's `ctc_loss_scan`): the arguments of `ctc_loss`; -> (B,),
    with gradients from autograd through `ctc_loss_fwd_reference`'s loop.
    A row no alignment fits has nll 1e30 (-LOG_EPS) and zero gradient."""
    dev = log_probs.device
    return ctc_loss_fwd_reference(log_probs, input_lengths.to(dev),
                                  labels.to(dev), label_lengths.to(dev),
                                  blank)[0]


def ctc_loss_sum_mean(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                      labels: torch.Tensor, label_lengths: torch.Tensor,
                      blank: int = 0) -> torch.Tensor:
    """sum-over-batch / batch_size — the reference's training objective
    (nn.CTCLoss(reduction='sum') / batch_size, train_ctc.py:72-74)."""
    nll = ctc_loss(log_probs, input_lengths, labels, label_lengths, blank)
    return nll.sum() / log_probs.shape[1]
