"""Device milliseconds a step of the library's matrix-product and
convolution kernels (cuBLAS and cuDNN: the LSTM input projections, the
attention and key products, the head, the convolutions), classed by
their names."""

import re

LIBRARY = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|cublas|splitk|conv|"
                     r"wgrad|dgrad|fprop|cudnn|winograd", re.IGNORECASE)


def read(rec):
    if not rec.kernels or not rec.steps:
        return None
    return 1e3 * rec.kernel_seconds(LIBRARY.search) / rec.steps
