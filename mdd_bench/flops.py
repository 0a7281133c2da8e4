"""The yardstick's arithmetic: the train step's FLOP count, the acoustic
recurrence's least work, and the card's published peaks.

`train_step_flops` is three times the forward's matrix work, which the
configuration's family counts (`families/<family>.py`'s `row_flops`; for
`cnn_bilstm` a frozen copy of `mdd_tpu_torch/bench.py`'s count); the
harness sums it over a batch's real rows, each at its own frame count and
transcript length, so padding counts as no work.

`recurrence_steps`, `lstm_fwd_work` and `lstm_bwd_work` belong to the
`cnn_bilstm` family's LSTM rooflines (`trace.Record.lstm_roofline`):
`lstm_fwd_work` and `lstm_bwd_work` are the operations and bytes of one
layer's two-direction recurrence under the contract of mdd_tpu's Pallas
kernels (`_fwd_kernel`, `_bwd_kernel` in mdd_tpu/ops/lstm_pallas.py),
whatever implements it: the forward's recurrent product h_{t-1} @ W_hh a
step; the backward's three products a step (the gates recomputed from
h_{t-1}, dh = dgates @ W_hh^T and dW_hh += h_{t-1}^T @ dgates).  Each
input is read once and each output written once: the forward reads the
projections and W_hh and writes hs and cs; the backward reads the
projections, W_hh, hs, cs and the float32 dhs and writes dx_proj and the
float32 dW_hh.
"""

from __future__ import annotations

from typing import Optional

from mdd_bench import manifest

# Dense peaks of one card by torch.cuda.get_device_name and dtype: NVIDIA's
# H100 SXM data sheet at its 700 W limit (bf16 on the tensor cores;
# float32 outside them), and its HBM3 bandwidth.
H100_SXM = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = {H100_SXM: {"bfloat16": 989e12, "float32": 67e12}}
PEAK_BYTES_S = {H100_SXM: 3.35e12}
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def peak_flops(card: str, dtype: str) -> Optional[float]:
    return PEAK_FLOPS.get(card, {}).get(dtype)


def peak_bytes_s(card: str) -> Optional[float]:
    return PEAK_BYTES_S.get(card)


def train_step_flops(cfg: dict, batch: int, frames: int,
                     label_len: int) -> float:
    """Analytic FLOPs of one training step of `batch` rows of `frames`
    spliced input frames and `label_len` transcript phones: three times
    the forward's matrix work (the family's `row_flops`), for the forward
    and the backward's two products a forward product."""
    return 3.0 * batch * manifest.family(cfg).row_flops(cfg, frames,
                                                        label_len)


def model_frames(cfg: dict, raw_len: int) -> int:
    """Spliced frames the model reads for `raw_len` raw frames: every
    n_skip_frame-th frame, padded to a multiple of n_downsample."""
    skip, mult = max(cfg["n_skip_frame"], 1), cfg["n_downsample"]
    n = -(-raw_len // skip)
    return -(-n // mult) * mult


def recurrence_steps(cfg: dict, bucket: int) -> int:
    """The acoustic LSTMs' sequence length for a raw-frame bucket."""
    t = bucket // max(cfg["n_skip_frame"], 1)
    for (kt, _), (st, _), (pt, _) in zip(cfg["kernel_size"], cfg["stride"],
                                         cfg["padding"]):
        t = (t + 2 * pt - kt) // st + 1
    return t


def lstm_fwd_work(t: int, b: int, h: int, dtype: str):
    """(operations, bytes) of one two-direction layer's forward recurrence
    over (T, B) at hidden size H."""
    e = DTYPE_BYTES[dtype]
    ops = 2.0 * t * 2 * b * h * 4 * h
    byts = (t * 2 * b * 4 * h * e          # projections
            + 2 * h * 4 * h * e            # W_hh
            + 2 * t * 2 * b * h * e)       # hs, cs
    return ops, byts


def lstm_bwd_work(t: int, b: int, h: int, dtype: str):
    """(operations, bytes) of the same layer's backward recurrence."""
    e = DTYPE_BYTES[dtype]
    ops = 3 * 2.0 * t * 2 * b * h * 4 * h
    byts = (t * 2 * b * 4 * h * e          # projections
            + 2 * h * 4 * h * e            # W_hh
            + 2 * t * 2 * b * h * e        # hs, cs
            + t * 2 * b * h * 4            # dhs, float32
            + t * 2 * b * 4 * h * e        # dx_proj
            + 2 * h * 4 * h * 4)           # dW_hh, float32
    return ops, byts


def least_seconds(ops: float, byts: float, card: str,
                  dtype: str) -> Optional[float]:
    """The larger of the operations over the dtype's peak and the bytes
    over the card's bandwidth; None for a card not listed."""
    pf, pb = peak_flops(card, dtype), peak_bytes_s(card)
    if pf is None or pb is None:
        return None
    return max(ops / pf, byts / pb)
