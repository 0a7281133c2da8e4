"""Tensor functions of the port: the plain LSTM, the CUDA LSTM kernels'
bindings, attention, the CTC loss and the device WER counts."""
