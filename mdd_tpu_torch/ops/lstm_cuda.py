"""Fused two-direction LSTM recurrence: the Hopper kernels and their plain
versions.

Counterpart of mdd_tpu/ops/lstm_pallas.py.  `lstm_seq` and the
`bilstm_cuda` facade keep that module's contract and layout:
projections (T, 2, B, 4H) with the direction axis separate from batch,
recurrent weights (2, H, 4H), hidden states (T, 2, B, H); dot operands in
the compute dtype, float32 accumulation and gate math, and the cell state
carried in float32 for the whole sequence.

On a CUDA tensor `lstm_seq_fwd` launches the kernel of
`csrc/lstm_fwd.cu` and `lstm_seq_bwd` the kernels of `csrc/lstm_bwd.cu`
(see the notes there for their design), or raise; on a CPU tensor they run
`lstm_seq_fwd_reference` and `lstm_seq_bwd_reference`, the plain PyTorch
versions that the tests and chip_smoke.py hold the kernels against.
`LstmSeq` pairs the two as one autograd Function (the custom VJP of
lstm_pallas.lstm_seq).
"""

from __future__ import annotations

import ctypes

import torch

from mdd_tpu_torch.ops import build
from mdd_tpu_torch.ops.lstm import input_projections

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def lstm_seq_fwd_reference(x_proj: torch.Tensor, w_hh: torch.Tensor):
    """(T, 2, B, 4H), (2, H, 4H) -> (hs, cs) each (T, 2, B, H), x_proj.dtype.

    Step by step what the kernel computes: the recurrent dot in float32 over
    operands rounded to x_proj's dtype (exact products, float32 sums), the
    gates in float32, h carried in x_proj's dtype and c in float32."""
    t, d, b, four_h = x_proj.shape
    h = four_h // 4
    dtype = x_proj.dtype
    w = w_hh.to(dtype).float()
    h_prev = torch.zeros((d, b, h), dtype=dtype, device=x_proj.device)
    c = torch.zeros((d, b, h), dtype=torch.float32, device=x_proj.device)
    hs, cs = [], []
    for step in range(t):
        gates = x_proj[step].float() + torch.bmm(h_prev.float(), w)
        i, f, g, o = gates.split(h, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c)
        h_prev = h_new.to(dtype)
        hs.append(h_prev)
        cs.append(c.to(dtype))
    return torch.stack(hs), torch.stack(cs)


def lstm_seq_bwd_reference(x_proj, w_hh, hs, cs, dhs):
    """The backward of `lstm_seq_fwd_reference` (_lstm_seq_bwd's contract):
    -> (dx_proj in x_proj.dtype, dW_hh float32).

    Walks t from T-1 down to 0 as the kernel does: gates recomputed from
    h_{t-1} (hs, zero at t = 0) with dot operands in x_proj's dtype and
    float32 sums, dh and dc carried in float32, c read from the saved cs
    stream, and dgates rounded to x_proj's dtype before both products."""
    t, d, b, four_h = x_proj.shape
    h = four_h // 4
    dtype = x_proj.dtype
    w = w_hh.to(dtype).float()
    w_t = w.transpose(1, 2)
    dhs = dhs.float()
    zeros = torch.zeros((d, b, h), dtype=torch.float32, device=x_proj.device)
    dh, dc = zeros, zeros
    dw = torch.zeros((d, h, four_h), dtype=torch.float32,
                     device=x_proj.device)
    dxp = torch.empty_like(x_proj)
    for step in range(t - 1, -1, -1):
        h_prev = hs[step - 1].float() if step > 0 else zeros
        c_prev = cs[step - 1].float() if step > 0 else zeros
        c_t = cs[step].float()
        dh_total = dhs[step] + dh
        gates = x_proj[step].float() + torch.bmm(h_prev, w)
        i, f, g, o = gates.split(h, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        tanh_c = torch.tanh(c_t)
        dc = dh_total * o * (1.0 - tanh_c * tanh_c) + dc
        dgates = torch.cat([dc * g * i * (1.0 - i),
                            dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - g * g),
                            dh_total * tanh_c * o * (1.0 - o)], dim=-1)
        dg_lp = dgates.to(dtype)
        dxp[step] = dg_lp
        dh = torch.bmm(dg_lp.float(), w_t)
        dw = dw + torch.bmm(h_prev.transpose(1, 2), dg_lp.float())
        dc = dc * f
    return dxp, dw


def _check_lstm_inputs(x_proj, w_hh, units_per_block):
    """The shapes, dtypes and devices both LSTM kernels take; -> (T, B, H).
    The device and dtype are checked before `units_per_block()` builds or
    loads anything."""
    if x_proj.device.type != "cuda" or w_hh.device != x_proj.device:
        raise ValueError("the LSTM kernels take CUDA tensors on one "
                         f"device, got {x_proj.device} and {w_hh.device}")
    if x_proj.dtype not in _DTYPE_CODES or w_hh.dtype != x_proj.dtype:
        raise TypeError("the LSTM kernels take float32 or bfloat16 "
                        f"x_proj and w_hh of the same dtype, got "
                        f"{x_proj.dtype} and {w_hh.dtype}")
    if x_proj.dim() != 4 or x_proj.shape[1] != 2:
        raise ValueError(f"x_proj must be (T, 2, B, 4H), got "
                         f"{tuple(x_proj.shape)}")
    t, d, b, four_h = x_proj.shape
    h = four_h // 4
    units = units_per_block()
    if (four_h % 4 or h % units or t < 1 or b < 1
            or tuple(w_hh.shape) != (d, h, four_h)):
        raise ValueError(
            f"unsupported LSTM shapes x_proj {tuple(x_proj.shape)}, "
            f"w_hh {tuple(w_hh.shape)}: need T, B >= 1, H % {units} == 0 "
            "and w_hh of shape (2, H, 4H)")
    if not (x_proj.is_contiguous() and w_hh.is_contiguous()):
        raise ValueError("the LSTM kernels take contiguous tensors")
    return t, b, h


class _LstmBinding(build.KernelBinding):
    """An LSTM kernel: n_pointers tensors, then T, B, H and the dtype."""

    n_pointers = 0

    @property
    def argtypes(self):
        return (ctypes.c_void_p,) * self.n_pointers + (ctypes.c_int,) * 4

    def units_per_block(self) -> int:
        """Hidden units each block owns; H must be a multiple of it."""
        units = getattr(self.library(), self.entry + "_units_per_block")
        units.argtypes = []
        units.restype = ctypes.c_int
        return units()


#: one zeroed 128-byte line of counters per barrier group of the kernels
_COUNTER_STRIDE = 32
_ROWS_TILE = 16


def _barrier_counters(b: int, device) -> torch.Tensor:
    """Zeroed counters for every (direction, batch group) there can be."""
    return torch.zeros(2 * -(-b // _ROWS_TILE) * _COUNTER_STRIDE,
                       dtype=torch.int32, device=device)


class LstmFwdKernel(_LstmBinding):
    """`mdd_lstm_fwd` of csrc/lstm_fwd.cu: (x_proj, w_hh) -> (hs, cs)."""

    source, entry, n_pointers = "lstm_fwd.cu", "mdd_lstm_fwd", 5

    def plan(self, b: int, h: int, dtype: torch.dtype) -> dict:
        """How the kernel lays a batch of b rows out on the current card
        (a block owns one 16-row batch tile): unit groups of 8 a block
        owns, whether the float32 w_hh slice is split into TF32 parts at
        load, blocks and shared bytes of a launch, batch rows a launch,
        launches a call."""
        fn = self.library().mdd_lstm_fwd_plan
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * 6)()
        err = fn(b, h, _DTYPE_CODES[dtype], out)
        if err != 0:
            raise ValueError(
                f"lstm_fwd has no layout for B={b}, H={h} in {dtype}: "
                + self.library().mdd_cuda_error_string(err).decode())
        return dict(zip(("unit_groups", "split_w", "blocks", "smem_bytes",
                         "chunk_rows", "launches"), out))

    def __call__(self, x_proj: torch.Tensor, w_hh: torch.Tensor):
        t, b, h = _check_lstm_inputs(x_proj, w_hh, self.units_per_block)
        if w_hh.data_ptr() % 16:     # the kernel reads it 16 bytes at a time
            w_hh = w_hh.clone()
        dev = x_proj.device
        hs = torch.empty((t, 2, b, h), dtype=x_proj.dtype, device=dev)
        cs = torch.empty_like(hs)
        self._launch(dev, x_proj.data_ptr(), w_hh.data_ptr(), hs.data_ptr(),
                     cs.data_ptr(), _barrier_counters(b, dev).data_ptr(),
                     t, b, h, _DTYPE_CODES[x_proj.dtype])
        return hs, cs


class LstmBwdKernel(_LstmBinding):
    """`mdd_lstm_bwd` of csrc/lstm_bwd.cu: (x_proj, w_hh, hs, cs, dhs) ->
    (dx_proj, dW_hh float32).  Inside: the gate pre-activations of every
    step as one product, the recurrence (one launch, or one a chunk of the
    batch), and the dW_hh product with its reduce; one count a backward."""

    source, entry, n_pointers = "lstm_bwd.cu", "mdd_lstm_bwd", 11
    #: `parts` bits of the entry point; ALL is the backward
    Z_PRODUCT, CHAIN, DW_PRODUCT, ALL = 1, 2, 4, 7

    @property
    def argtypes(self):
        return (ctypes.c_void_p,) * self.n_pointers + (ctypes.c_int,) * 5

    def plan(self, t: int, b: int, h: int, dtype: torch.dtype) -> dict:
        """How the kernels lay a call of these shapes out on the current
        card (a recurrence block owns one 16-row batch tile): unit groups
        of 8 a recurrence block owns, blocks and shared bytes of a
        recurrence launch, slices of dW_hh's reduction, float32 elements of
        the exchange, batch rows of a recurrence launch and recurrence
        launches a call (a batch too large for resident blocks runs as
        several)."""
        fn = self.library().mdd_lstm_bwd_plan
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * 7)()
        err = fn(t, b, h, _DTYPE_CODES[dtype], out)
        if err != 0:
            raise ValueError(
                f"lstm_bwd has no layout for B={b}, H={h} in {dtype}: "
                + self.library().mdd_cuda_error_string(err).decode())
        return dict(zip(("unit_groups", "blocks", "smem_bytes", "k_slices",
                         "exchange_elems", "chunk_rows", "launches"), out))

    def _check(self, x_proj, w_hh, hs, cs, dhs):
        t, b, h = _check_lstm_inputs(x_proj, w_hh, self.units_per_block)
        want = (t, 2, b, h)
        for name, a, dtype in (("hs", hs, x_proj.dtype),
                               ("cs", cs, x_proj.dtype),
                               ("dhs", dhs, torch.float32)):
            if (tuple(a.shape) != want or a.dtype != dtype
                    or a.device != x_proj.device or not a.is_contiguous()):
                raise ValueError(
                    f"{name} must be a contiguous {dtype} tensor of shape "
                    f"{want} on {x_proj.device}, got {a.dtype} "
                    f"{tuple(a.shape)} on {a.device}")
        return t, b, h

    def buffers(self, x_proj) -> tuple:
        """(dx_proj, dW_hh, z, dW_hh partial sums, exchange) for a call on
        x_proj: the outputs, the float32 gate pre-activations (T, 2, B, 4H),
        one (2, H, 4H) float32 partial sum per slice of dW_hh's reduction,
        and the float32 partial dh the recurrence's blocks pass each other."""
        t, _, b, four_h = x_proj.shape
        h, dev = four_h // 4, x_proj.device
        with torch.cuda.device(dev):
            plan = self.plan(t, b, h, x_proj.dtype)
        f32 = dict(dtype=torch.float32, device=dev)
        return (torch.empty_like(x_proj), torch.empty((2, h, four_h), **f32),
                torch.empty((t, 2, b, four_h), **f32),
                torch.empty((plan["k_slices"], 2, h, four_h), **f32),
                torch.empty(plan["exchange_elems"], **f32))

    def run_parts(self, x_proj, w_hh, hs, cs, dhs, buffers, parts) -> None:
        """Launch the kernels that `parts` names into `buffers`.  A part
        reads what the earlier ones left there; anything but ALL exists to
        time the launches one by one."""
        t, b, h = self._check(x_proj, w_hh, hs, cs, dhs)
        dxp, dw, z, dw_partial, exchange = buffers
        self._launch(x_proj.device, x_proj.data_ptr(), w_hh.data_ptr(),
                     hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
                     dxp.data_ptr(), dw.data_ptr(), z.data_ptr(),
                     dw_partial.data_ptr(), exchange.data_ptr(),
                     _barrier_counters(b, x_proj.device).data_ptr(), t, b, h,
                     _DTYPE_CODES[x_proj.dtype], parts)

    def __call__(self, x_proj, w_hh, hs, cs, dhs):
        self._check(x_proj, w_hh, hs, cs, dhs)
        buffers = self.buffers(x_proj)
        self.run_parts(x_proj, w_hh, hs, cs, dhs, buffers, self.ALL)
        return buffers[0], buffers[1]


#: the process's bindings; chip_smoke.py reads and resets their counters
lstm_fwd_kernel = LstmFwdKernel()
lstm_bwd_kernel = LstmBwdKernel()


def lstm_seq_fwd(x_proj: torch.Tensor, w_hh: torch.Tensor):
    """(T, 2, B, 4H), (2, H, 4H) -> (hs, cs): the kernel on a CUDA tensor,
    the plain version on a CPU tensor.  w_hh is cast to x_proj's dtype, as
    the Pallas kernel casts it."""
    w_hh = w_hh.to(x_proj.dtype)
    if x_proj.device.type == "cpu":
        return lstm_seq_fwd_reference(x_proj, w_hh)
    return lstm_fwd_kernel(x_proj.contiguous(), w_hh.contiguous())


def lstm_seq_bwd(x_proj, w_hh, hs, cs, dhs):
    """-> (dx_proj in x_proj.dtype, dW_hh float32): the kernels on a CUDA
    tensor, the plain version on a CPU tensor.  w_hh is cast to x_proj's
    dtype and dhs to float32, as _lstm_seq_bwd casts them."""
    w_hh = w_hh.to(x_proj.dtype)
    dhs = dhs.float()
    if x_proj.device.type == "cpu":
        return lstm_seq_bwd_reference(x_proj, w_hh, hs, cs, dhs)
    return lstm_bwd_kernel(*(a.contiguous() for a in
                             (x_proj, w_hh, hs, cs, dhs)))


class LstmSeq(torch.autograd.Function):
    """lstm_seq with its hand-written backward (lstm_pallas's custom VJP):
    the forward saves (x_proj, w_hh, hs, cs), the backward returns
    (dx_proj in x_proj.dtype, dW_hh in w_hh.dtype)."""

    @staticmethod
    def forward(ctx, x_proj, w_hh):
        hs, cs = lstm_seq_fwd(x_proj, w_hh)
        ctx.save_for_backward(x_proj, w_hh, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        x_proj, w_hh, hs, cs = ctx.saved_tensors
        dxp, dw = lstm_seq_bwd(x_proj, w_hh, hs, cs, dhs)
        return dxp.to(x_proj.dtype), dw.to(w_hh.dtype)


def lstm_seq(x_proj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """(T, 2, B, 4H) projections + (2, H, 4H) recurrent weights ->
    (T, 2, B, H) hidden states, differentiable in both."""
    return LstmSeq.apply(x_proj, w_hh)


def bilstm_cuda(x, w_ih_fwd, w_hh_fwd, w_ih_bwd, w_hh_bwd,
                b_fwd=None, b_bwd=None) -> torch.Tensor:
    """Drop-in for ops.lstm.bilstm over (T, B, D) -> (T, B, 2H), with the
    recurrence in `lstm_seq` (counterpart of bilstm_pallas)."""
    xf, xb = input_projections(x, w_ih_fwd, w_ih_bwd)
    if b_fwd is not None:
        xf = xf + b_fwd
    if b_bwd is not None:
        xb = xb + b_bwd
    x_proj = torch.stack([xf, xb], dim=1).to(x.dtype)
    hs = lstm_seq(x_proj, torch.stack([w_hh_fwd, w_hh_bwd]))
    return torch.cat([hs[:, 0], torch.flip(hs[:, 1], (0,))],
                     dim=-1).to(x.dtype)
