"""The acoustic recurrence forward's least time (flops.lstm_fwd_work at
each traced step's shapes, every layer, the larger of its operations over
the compute dtype's peak and its bytes over the HBM bandwidth) over the
device time of `lstm_fwd_kernel` in the trace, in %."""


def read(rec):
    return rec.lstm_roofline("fwd")
