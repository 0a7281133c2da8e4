"""Tensor functions of the port: the plain LSTM, the CUDA LSTM kernels'
bindings, attention, the CTC loss and the device WER counts.

mdd_tpu's package also re-exports `ctc_loss`, which there hides its
module `ops.ctc_loss`; here the name stays the module's
(`from mdd_tpu_torch.ops.ctc_loss import ctc_loss`)."""

from mdd_tpu_torch.ops.lstm import lstm_scan, bilstm
from mdd_tpu_torch.ops.ctc_loss import ctc_loss_sum_mean
from mdd_tpu_torch.ops.attention import dot_attention
