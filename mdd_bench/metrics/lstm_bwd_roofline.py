"""The acoustic recurrence backward's least time (flops.lstm_bwd_work at
each traced step's shapes, every layer) over the device time of the
kernels of csrc/lstm_bwd.cu (`lstm_bwd_chain_kernel`,
`lstm_product_kernel`, `lstm_dw_reduce_kernel`) in the trace, in %."""


def read(rec):
    return rec.lstm_roofline("bwd")
