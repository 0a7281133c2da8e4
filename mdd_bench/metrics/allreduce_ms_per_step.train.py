"""Device milliseconds a step of the NCCL kernels on this rank's card (by
their names): the gradients' all-reduce, the sharded cache's gather
(a reduce-scatter) and the window's epoch-end agreement on whether to
stop; nothing where the trace has no NCCL kernel (one process)."""


def read(rec):
    spent = rec.kernel_seconds(lambda n: "nccl" in n.lower())
    if spent <= 0 or not rec.steps:
        return None
    return 1e3 * spent / rec.steps
