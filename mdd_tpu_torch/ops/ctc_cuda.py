"""The CTC loss's recursions as two Hopper kernels, and their plain versions.

Counterpart of mdd_tpu/ops/ctc_loss.py's custom VJP: `_prep` +
`_alpha_scan` (the forward) and `_beta_scan` + `_ctc_bwd` (the backward,
-posterior at the log-probs).  mdd_tpu compiles each recursion into its
train step as one lax.scan; here, on a CUDA tensor, `ctc_loss_fwd`
launches `ctc_alpha` and `ctc_loss_bwd` launches `ctc_beta_grad` of
`csrc/ctc_loss.cu` (see the notes there for their design), or raise; on a
CPU tensor they run `ctc_loss_fwd_reference` and `ctc_loss_bwd_reference`,
the plain PyTorch versions that the tests and chip_smoke.py hold the
kernels against.  `CtcLoss` pairs the two as one autograd Function, as
ops/lstm_cuda.LstmSeq pairs the LSTM kernels.

Both versions keep mdd_tpu's arithmetic: the floor LOG_EPS = -1e30, a
logsumexp of three that returns the floor when its max is <= LOG_EPS / 2,
frame 0's emission counted at every input length (0 included), nll = 1e30
and a zero gradient on a row no alignment fits.  Lengths are clamped to
[0, T] and [0, L]; an id outside [0, C) emits 0, as mdd_tpu's one-hot
row of zeros does.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mdd_tpu_torch.ops.build import KernelBinding

LOG_EPS = -1e30
#: the kernels' limits: S = 2L + 1 extended slots (ctc_beta_grad's block
#: holds a thread a slot, ctc_alpha's warp at most 32 a lane) and C classes
MAX_SLOTS = 1023
MAX_CLASSES = 1024
MAX_FRAME_CLASSES = 2 ** 31 - 1
#: H100 SXM (NVIDIA's data sheet): memory rate and float32 rate outside the
#: tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
#: float operations a slot and frame: the alpha step (3 exp, a log, the
#: max of three, 5 subtracts and adds, the floor test) and the beta step
#: with the posterior weight (the same, plus an exp, a min, 3 adds and the
#: class sum's add)
ALPHA_OPS = 12
BETA_GRAD_OPS = 18


def _logsumexp3(a, b, c):
    """log(e^a + e^b + e^c), LOG_EPS where all three are at the floor (the
    max is held constant, so the gradient is the softmax of the three).
    The exponentials are summed left to right, as the kernels sum them."""
    m = torch.maximum(torch.maximum(a, b), c).detach()
    out = m + torch.log((torch.exp(a - m) + torch.exp(b - m))
                        + torch.exp(c - m))
    return torch.where(m <= LOG_EPS / 2, torch.full_like(out, LOG_EPS), out)


def _clamped_lengths(t_max, l_max, input_lengths, label_lengths):
    """(B,) int64 input and label lengths clamped to [0, T] and [0, L]."""
    return (input_lengths.long().clamp(0, t_max),
            label_lengths.long().clamp(0, l_max))


def _extended_labels(labels, label_lengths, blank: int):
    """mdd_tpu's `_prep`: (B, L) labels -> the (B, S) blank-interleaved ids,
    the valid slots (s < 2 l + 1) and the slots a skip may enter (not
    blank, not the id two slots back)."""
    b, l = labels.shape
    s = 2 * l + 1
    ext = torch.full((b, s), blank, dtype=torch.long, device=labels.device)
    ext[:, 1::2] = labels.long()
    pos = torch.arange(s, device=labels.device)[None]
    valid_s = pos < 2 * label_lengths[:, None] + 1
    ext_m2 = F.pad(ext, (2, 0), value=blank)[:, :s]
    can_skip = (ext != blank) & (ext != ext_m2) & (pos >= 2)
    return ext, valid_s, can_skip


def _emissions(log_probs, ext):
    """(T, B, S): log_probs[t, b, ext[b, s]], 0 for an id outside [0, C)."""
    t, b, c = log_probs.shape
    inside = (ext >= 0) & (ext < c)
    e = log_probs.gather(2, ext.clamp(0, c - 1)[None].expand(t, b, -1))
    return torch.where(inside[None], e, torch.zeros_like(e))


def _nll(alpha, label_lengths):
    """-log(alpha[2l] + alpha[2l - 1]) of the last alpha, 1e30 at the floor."""
    end = 2 * label_lengths
    last = alpha.gather(1, end[:, None])[:, 0]
    second = alpha.gather(1, (end - 1).clamp_min(0)[:, None])[:, 0]
    second = torch.where(end >= 1, second, torch.full_like(second, LOG_EPS))
    m = torch.maximum(last, second).detach()
    ll = m + torch.log(torch.exp(last - m) + torch.exp(second - m))
    return -torch.where(m <= LOG_EPS / 2, torch.full_like(ll, LOG_EPS), ll)


def ctc_loss_fwd_reference(log_probs, input_lengths, labels, label_lengths,
                           blank: int = 0):
    """-> (nll (B,), alphas (T, B, S)): mdd_tpu's `_alpha_scan` step by step.
    A row's alpha stops at its input length and is carried unchanged to T;
    the kernel writes only the frames before the input length."""
    t_max, b, _ = log_probs.shape
    lens, lab = _clamped_lengths(t_max, labels.shape[1], input_lengths,
                                 label_lengths)
    ext, valid_s, can_skip = _extended_labels(labels, lab, blank)
    s = ext.shape[1]
    emit = _emissions(log_probs, ext)
    floor = torch.full((b, s), LOG_EPS, dtype=log_probs.dtype,
                       device=log_probs.device)
    pos = torch.arange(s, device=log_probs.device)[None]
    first = (pos == 0) | ((pos == 1) & (lab[:, None] > 0))
    alpha = torch.where(first, emit[0], floor)
    alphas = [alpha]
    for t in range(1, t_max):
        a_m1 = F.pad(alpha, (1, 0), value=LOG_EPS)[:, :s]
        a_m2 = torch.where(can_skip,
                           F.pad(alpha, (2, 0), value=LOG_EPS)[:, :s], floor)
        new = torch.where(valid_s, _logsumexp3(alpha, a_m1, a_m2) + emit[t],
                          floor)
        alpha = torch.where((t < lens)[:, None], new, alpha)
        alphas.append(alpha)
    return _nll(alpha, lab), torch.stack(alphas)


def ctc_loss_bwd_reference(log_probs, input_lengths, labels, label_lengths,
                           alphas, nll, g, blank: int = 0):
    """-> (T, B, C) d(sum g * nll) / d log_probs: mdd_tpu's `_beta_scan` and
    `_ctc_bwd` step by step, -g times the posterior of each class; 0 where
    alpha or beta is at the floor, at t >= the input length and on a row
    whose nll is >= 1e30 / 2."""
    t_max, b, c = log_probs.shape
    lens, lab = _clamped_lengths(t_max, labels.shape[1], input_lengths,
                                 label_lengths)
    ext, valid_s, can_skip = _extended_labels(labels, lab, blank)
    s = ext.shape[1]
    emit = _emissions(log_probs, ext)
    floor = torch.full((b, s), LOG_EPS, dtype=log_probs.dtype,
                       device=log_probs.device)
    pos = torch.arange(s, device=log_probs.device)[None]
    end = 2 * lab[:, None]
    terminal_slot = (pos == end) | ((pos == end - 1) & (end >= 1))
    can_skip_p2 = F.pad(can_skip, (0, 2))[:, 2:]
    beta = floor
    betas = torch.empty_like(emit)
    for t in range(t_max - 1, -1, -1):
        b_p1 = F.pad(beta, (0, 1), value=LOG_EPS)[:, 1:]
        b_p2 = torch.where(can_skip_p2,
                           F.pad(beta, (0, 2), value=LOG_EPS)[:, 2:], floor)
        summed = _logsumexp3(beta, b_p1, b_p2) + emit[t]
        terminal = torch.where(terminal_slot, emit[t], floor)
        new = torch.where((t == lens - 1)[:, None], terminal, summed)
        new = torch.where(valid_s, new, floor)
        beta = torch.where((t < lens)[:, None], new, floor)
        betas[t] = beta
    gamma = alphas + betas - emit
    w = torch.exp(torch.clamp(gamma + nll[None, :, None], max=20.0))
    dead = (alphas <= LOG_EPS / 2) | (betas <= LOG_EPS / 2)
    inside = ((ext >= 0) & (ext < c))[None]
    w = torch.where(dead | ~inside, torch.zeros_like(w), w)
    index = ext.clamp(0, c - 1)[None].expand(t_max, b, s)
    dlp = -torch.zeros((t_max, b, c), dtype=w.dtype,
                       device=w.device).scatter_add_(2, index, w)
    t_idx = torch.arange(t_max, device=log_probs.device)[:, None]
    keep = (t_idx < lens[None]) & (nll < -LOG_EPS / 2)[None]
    dlp = torch.where(keep[..., None], dlp, torch.zeros_like(dlp))
    return (dlp * g[None, :, None]).to(log_probs.dtype)


def _check(log_probs, input_lengths, labels, label_lengths, blank) -> None:
    """Raises for what the kernels do not take, but for the device (checked
    last by `_check_device`, so that every other refusal shows on CPU
    tensors too)."""
    if log_probs.dtype != torch.float32:
        raise TypeError("the CTC kernels take float32 log-probs, got "
                        f"{log_probs.dtype}")
    if log_probs.dim() != 3 or min(log_probs.shape) < 1:
        raise ValueError("log_probs must be (T, B, C) with T, B, C >= 1, got "
                         f"{tuple(log_probs.shape)}")
    if log_probs.stride(2) != 1:
        raise ValueError("the CTC kernels read a class row as contiguous "
                         "memory; pass log_probs.contiguous()")
    t, b, c = log_probs.shape
    for name, x, dim in (("input_lengths", input_lengths, 1),
                         ("labels", labels, 2),
                         ("label_lengths", label_lengths, 1)):
        if x.device != log_probs.device:
            raise ValueError(f"{name} lies on {x.device}, log_probs on "
                             f"{log_probs.device}")
        if x.dtype != torch.int64:
            raise TypeError(f"the CTC kernels take {name} as int64, got "
                            f"{x.dtype}")
        if x.dim() != dim or x.shape[0] != b:
            raise ValueError(f"{name} must be {dim}-D with {b} rows, got "
                             f"{tuple(x.shape)}")
    for name, x in (("input_lengths", input_lengths),
                    ("label_lengths", label_lengths)):
        if not x.is_contiguous():
            raise ValueError(f"the CTC kernels read {name} as contiguous "
                             f"memory; pass {name}.contiguous()")
    if 2 * labels.shape[1] + 1 > MAX_SLOTS:
        raise ValueError(f"the CTC kernels take at most {MAX_SLOTS} extended "
                         f"slots: labels of at most "
                         f"{(MAX_SLOTS - 1) // 2} columns, got "
                         f"{labels.shape[1]}")
    if c > MAX_CLASSES:
        raise ValueError(f"the CTC kernels take at most {MAX_CLASSES} "
                         f"classes, got {c}")
    if t * c > MAX_FRAME_CLASSES:
        raise ValueError(f"the CTC kernels count a row's (frame, class) "
                         f"pairs in 32 bits: T * C <= 2^31 - 1, got {t} * "
                         f"{c}")
    if not 0 <= blank < c:
        raise ValueError(f"blank {blank} is not a class of {c}")


def _check_device(log_probs) -> None:
    if log_probs.device.type != "cuda":
        raise ValueError("the CTC kernels take CUDA tensors, got log_probs "
                         f"on {log_probs.device}")


def _check_cotangents(log_probs, alphas, nll, g) -> None:
    t, b, _ = log_probs.shape
    for name, x, shape in (("nll", nll, (b,)), ("g", g, (b,)),
                           ("alphas", alphas, None)):
        if x.dtype != torch.float32 or x.device != log_probs.device \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{log_probs.device}, got {x.dtype} on "
                             f"{x.device}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if alphas.dim() != 3 or alphas.shape[:2] != (t, b):
        raise ValueError(f"alphas must be (T, B, S) = ({t}, {b}, S), got "
                         f"{tuple(alphas.shape)}")


_ARGS = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_longlong)


def _common(log_probs, input_lengths, labels, label_lengths, blank):
    t, b, c = log_probs.shape
    return (log_probs.data_ptr(), log_probs.stride(0), log_probs.stride(1),
            input_lengths.data_ptr(), labels.data_ptr(), labels.stride(0),
            labels.stride(1), label_lengths.data_ptr(), t, b, c,
            labels.shape[1], blank)


class CtcAlphaKernel(KernelBinding):
    """`mdd_ctc_alpha` of csrc/ctc_loss.cu: -> (nll (B,), alphas (T, B, S)),
    the alphas written for the frames before each row's input length."""

    source, entry = "ctc_loss.cu", "mdd_ctc_alpha"
    argtypes = _ARGS + (ctypes.c_void_p, ctypes.c_void_p)

    def __call__(self, log_probs, input_lengths, labels, label_lengths,
                 blank: int = 0):
        _check(log_probs, input_lengths, labels, label_lengths, blank)
        _check_device(log_probs)
        t, b, _ = log_probs.shape
        dev = log_probs.device
        alphas = torch.empty((t, b, 2 * labels.shape[1] + 1),
                             dtype=torch.float32, device=dev)
        nll = torch.empty(b, dtype=torch.float32, device=dev)
        self._launch(dev, *_common(log_probs, input_lengths, labels,
                                   label_lengths, blank),
                     alphas.data_ptr(), nll.data_ptr())
        return nll, alphas


def weights_shape(log_probs, labels) -> tuple:
    """The (T, B, S) float32 scratch of `ctc_beta_grad`: the posterior
    weights its frame chain writes and its class sums read."""
    return (log_probs.shape[0], log_probs.shape[1], 2 * labels.shape[1] + 1)


class CtcBetaGradKernel(KernelBinding):
    """`mdd_ctc_beta_grad` of csrc/ctc_loss.cu: -> dlog_probs, laid out as
    log_probs, every entry written."""

    source, entry = "ctc_loss.cu", "mdd_ctc_beta_grad"
    argtypes = _ARGS + (ctypes.c_void_p,) * 5 + (ctypes.c_longlong,) * 2

    def __call__(self, log_probs, input_lengths, labels, label_lengths,
                 alphas, nll, g, blank: int = 0):
        _check(log_probs, input_lengths, labels, label_lengths, blank)
        _check_cotangents(log_probs, alphas, nll, g)
        if alphas.shape[2] != 2 * labels.shape[1] + 1:
            raise ValueError(f"alphas have {alphas.shape[2]} slots, the "
                             f"labels {2 * labels.shape[1] + 1}")
        _check_device(log_probs)
        grad = torch.empty_like(log_probs)
        if grad.stride(2) != 1:
            grad = torch.empty(log_probs.shape, dtype=torch.float32,
                               device=log_probs.device)
        weights = torch.empty(weights_shape(log_probs, labels),
                              dtype=torch.float32, device=log_probs.device)
        self._launch(log_probs.device, *_common(log_probs, input_lengths,
                                                labels, label_lengths, blank),
                     alphas.data_ptr(), nll.data_ptr(), g.data_ptr(),
                     weights.data_ptr(), grad.data_ptr(), grad.stride(0),
                     grad.stride(1))
        return grad


#: the process's bindings; chip_smoke.py reads and resets their counters
ctc_alpha_kernel = CtcAlphaKernel()
ctc_beta_grad_kernel = CtcBetaGradKernel()


def ctc_loss_fwd(log_probs, input_lengths, labels, label_lengths,
                 blank: int = 0):
    """-> (nll, alphas): the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if log_probs.device.type == "cpu":
        return ctc_loss_fwd_reference(log_probs, input_lengths, labels,
                                      label_lengths, blank)
    if log_probs.stride(2) != 1:
        log_probs = log_probs.contiguous()
    return ctc_alpha_kernel(log_probs, input_lengths, labels, label_lengths,
                            blank)


def ctc_loss_bwd(log_probs, input_lengths, labels, label_lengths, alphas,
                 nll, g, blank: int = 0):
    """-> dlog_probs: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if log_probs.device.type == "cpu":
        return ctc_loss_bwd_reference(log_probs, input_lengths, labels,
                                      label_lengths, alphas, nll, g, blank)
    if log_probs.stride(2) != 1:
        log_probs = log_probs.contiguous()
    return ctc_beta_grad_kernel(log_probs, input_lengths, labels,
                                label_lengths, alphas, nll,
                                g.float().contiguous(), blank)


class CtcLoss(torch.autograd.Function):
    """mdd_tpu's `ctc_loss` custom VJP: the forward saves (log_probs, the
    lengths, the labels, alphas, nll), the backward returns the gradient at
    log_probs only."""

    @staticmethod
    def forward(ctx, log_probs, input_lengths, labels, label_lengths, blank):
        nll, alphas = ctc_loss_fwd(log_probs, input_lengths, labels,
                                   label_lengths, blank)
        ctx.blank = blank
        ctx.save_for_backward(log_probs, input_lengths, labels,
                              label_lengths, alphas, nll)
        return nll

    @staticmethod
    def backward(ctx, g):
        dlp = ctc_loss_bwd(*ctx.saved_tensors, g, ctx.blank)
        return dlp, None, None, None, None


def bound_ms(log_probs, input_lengths, labels, label_lengths,
             kernel: str) -> tuple:
    """(least ms, "bytes" or "operations") of `kernel` ("ctc_alpha" or
    "ctc_beta_grad") on these inputs: each row's emissions and alphas over
    its own frames and valid slots read or written once, the labels and
    lengths read once, nll (and g) once, and for the backward the whole
    dlog_probs written once; ALPHA_OPS or BETA_GRAD_OPS a slot and frame."""
    t, b, c = log_probs.shape
    lens, lab = _clamped_lengths(t, labels.shape[1], input_lengths,
                                 label_lengths)
    cells = (lens * (2 * lab + 1)).sum().item()
    small = labels.numel() * 8 + b * (8 + 8 + 4)
    if kernel == "ctc_alpha":
        nbytes, ops = 2 * 4 * cells + small, ALPHA_OPS * cells
    else:
        nbytes = 2 * 4 * cells + small + b * 4 + t * b * c * 4
        ops = BETA_GRAD_OPS * cells
    by_bytes = nbytes / PEAK_BYTES_S * 1e3
    by_ops = ops / PEAK_F32_OPS_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")
