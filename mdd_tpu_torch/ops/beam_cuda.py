"""The batched CTC prefix beam search as one kernel launch.

Counterpart of mdd_tpu/decode/beam_jit.py's `_beam_search_batch` (a
lax.scan over the frames that mdd_tpu compiles into one device program):
`ctc_beam_kernel` launches `csrc/ctc_beam.cu` (see the notes there) on
CUDA tensors or raises.  decode/beam_jit.beam_search sends a CUDA tensor
here and a CPU tensor to decode/beam_jit.beam_search_batch, the plain
version, whose sequences the kernel's equal on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mdd_tpu_torch.ops.build import KernelBinding

#: what the kernel takes: beam width, classes, the LM matrix's side (V + 1)
MAX_BEAM = 16
MAX_CLASSES = 64
MAX_LM_SIDE = 65
#: H100 SXM (NVIDIA's data sheet): memory rate, float32 rate outside the
#: tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_F32 = 67e12
#: float operations a candidate and kept frame: the two adds of an
#: extension's value, the LM term's add, one compare to select
OPS_PER_CANDIDATE = 4


def kept_frames(log_probs, lengths, blank: int,
                blank_skip_threshold: float) -> torch.Tensor:
    """(B,) frames the search does not skip: t < length and not
    blank-dominated (the plain version's gate)."""
    b, t, _ = log_probs.shape
    frames = torch.arange(t, device=log_probs.device)
    live = frames[None, :] < lengths.to(log_probs.device)[:, None]
    p_blank = torch.exp(log_probs[:, :, blank])
    dominated = (1.0 - p_blank) < blank_skip_threshold
    return (live & ~dominated).sum(dim=1)


def bound_ms(log_probs, lengths, lm_matrix, beam_width: int, blank: int,
             blank_skip_threshold: float) -> tuple:
    """(least ms, "bytes" or "operations") for these inputs: each row's own
    frames of log-probs, the LM matrix and the lengths read once, the
    prefixes and lengths written once; OPS_PER_CANDIDATE float operations
    a candidate on each kept frame (what this data needs)."""
    b, t, c = log_probs.shape
    n = lengths.to(log_probs.device).clamp(0, t)
    read = n.sum().item() * c * 4 + lm_matrix.numel() * 4 + b * 8
    by_bytes = (read + b * t * 8 + b * 8) / PEAK_BYTES_S * 1e3
    kept = kept_frames(log_probs, lengths, blank,
                       blank_skip_threshold).sum().item()
    ops = kept * beam_width * (c + 1) * OPS_PER_CANDIDATE
    by_ops = ops / PEAK_FLOPS_F32 * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _check(log_probs, lengths, lm_matrix, beam_width: int, blank: int):
    """Raises for what the kernel does not take; the device last, so that
    every other refusal shows on CPU tensors too."""
    for name, x, dtype, dim in (("log_probs", log_probs, torch.float32, 3),
                                ("lengths", lengths, torch.int64, 1),
                                ("lm_matrix", lm_matrix, torch.float32, 2)):
        if x.device != log_probs.device:
            raise ValueError(f"{name} lies on {x.device}, log_probs on "
                             f"{log_probs.device}")
        if x.dtype != dtype:
            raise TypeError(f"the beam kernel takes {name} as {dtype}, got "
                            f"{x.dtype}")
        if x.dim() != dim:
            raise ValueError(f"{name} must be {dim}-D, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"the beam kernel reads {name} as contiguous "
                             f"memory; pass {name}.contiguous()")
    b, _, c = log_probs.shape
    side = lm_matrix.shape[0]
    if b < 1:
        raise ValueError("the beam kernel takes at least one row")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
    if not 1 <= beam_width <= MAX_BEAM:
        raise ValueError(f"the beam kernel takes a beam width of 1 to "
                         f"{MAX_BEAM}, got {beam_width}")
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"the beam kernel takes 1 to {MAX_CLASSES} classes, "
                         f"got {c}")
    if lm_matrix.shape != (side, side) or not c <= side <= MAX_LM_SIDE:
        raise ValueError(f"the beam kernel takes a square LM matrix of side "
                         f"V + 1 in [{c}, {MAX_LM_SIDE}] for {c} classes, got "
                         f"{tuple(lm_matrix.shape)}")
    if not 0 <= blank < c:
        raise ValueError(f"blank {blank} is not one of the {c} classes")
    if log_probs.device.type != "cuda":
        raise ValueError("the beam kernel takes CUDA tensors, got log_probs "
                         f"on {log_probs.device}")


class CtcBeamKernel(KernelBinding):
    """`mdd_ctc_beam` of csrc/ctc_beam.cu: -> (best prefixes (B, T) int64,
    their lengths (B,) int64), as beam_search_batch returns them, and with
    `scores` their normalised scores (B,) float32."""

    source, entry = "ctc_beam.cu", "mdd_ctc_beam"
    argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_float)

    def __call__(self, log_probs, lengths, lm_matrix, beam_width: int,
                 blank: int, blank_skip_threshold: float,
                 scores: bool = False):
        _check(log_probs, lengths, lm_matrix, beam_width, blank)
        b, t, c = log_probs.shape
        dev = log_probs.device
        prefixes = torch.empty((b, t), dtype=torch.int64, device=dev)
        lens = torch.empty(b, dtype=torch.int64, device=dev)
        norm = torch.empty(b, dtype=torch.float32, device=dev)
        back = torch.empty(max(b * t * beam_width, 1), dtype=torch.int16,
                           device=dev)
        self._launch(dev, log_probs.data_ptr(), lengths.data_ptr(),
                     lm_matrix.data_ptr(), prefixes.data_ptr(),
                     lens.data_ptr(), norm.data_ptr(), back.data_ptr(), b,
                     t, c,
                     lm_matrix.shape[0], beam_width, blank,
                     blank_skip_threshold, math.log(0.9))
        return (prefixes, lens, norm) if scores else (prefixes, lens)


#: the process's binding; chip_smoke.py reads and resets its counter
ctc_beam_kernel = CtcBeamKernel()
