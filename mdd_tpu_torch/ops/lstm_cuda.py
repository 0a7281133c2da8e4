"""Fused two-direction LSTM recurrence: the Hopper kernels and their plain
versions, under two contracts.

Both keep mdd_tpu's layout: projections (T, 2, B, 4H) with the direction
axis separate from batch, recurrent weights (2, H, 4H), hidden states
(T, 2, B, H); dot operands in the compute dtype, float32 accumulation and
gate math.  They differ in what is rounded to the compute dtype:

- **The Pallas contract** (mdd_tpu/ops/lstm_pallas.py): `lstm_seq` and
  the `bilstm_cuda` facade.  h is carried in the compute dtype and c in
  float32 for the whole sequence; the backward carries dh and dc in
  float32, rounds dgates before both products and sums dW_hh once in
  float32.  On a CUDA tensor `lstm_seq_fwd` launches the kernel of
  `csrc/lstm_fwd.cu` and `lstm_seq_bwd` the kernels of `csrc/lstm_bwd.cu`.
- **The scan contract** (mdd_tpu/ops/lstm.py's `lax.scan` and JAX's
  autodiff of it): `lstm_scan` and the `bilstm_scan_cuda` facade.  h and
  c are rounded to the compute dtype every step (tanh takes the unrounded
  c); the backward carries bfloat16 cotangents, as JAX's does (see
  `lstm_scan_bwd_reference`).  On a CUDA tensor `lstm_scan_fwd` and
  `lstm_scan_bwd` launch the kernels of `csrc/lstm_scan.cu`, in bfloat16
  only: in float32 the two contracts are one, and the model takes the
  Pallas one there.  Their products of float32 dgates against bfloat16
  operands split each dgate exactly into three bfloat16 parts
  (`bf16_split3`), and dW_hh is summed in the order `lstm_scan_dw_reference`
  models: every step's rounded product, then the ordered bfloat16 carry.

On a CPU tensor each wrapper runs its `*_reference` function, the plain
PyTorch versions that the tests and chip_smoke.py hold the kernels
against (see the notes in the `.cu` files for the kernels' design).
`LstmSeq` and `LstmScan` pair each contract's two halves as one autograd
Function.
"""

from __future__ import annotations

import ctypes

import torch

from mdd_tpu_torch.ops import build
from mdd_tpu_torch.ops.lstm import projections

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


def lstm_scan_fwd_reference(x_proj: torch.Tensor, w_hh: torch.Tensor):
    """(T, 2, B, 4H), (2, H, 4H) -> (hs in x_proj.dtype, cs float32).

    Step by step what mdd_tpu/ops/lstm.py's `bilstm` scan computes and the
    scan kernel repeats: the recurrent dot in float32 over operands in
    x_proj's dtype, the gates in float32, c_t = sig(f) c_{t-1} + sig(i)
    tanh(g) from the ROUNDED c_{t-1}, h_t = sig(o) tanh(c_t) of the
    unrounded c_t, and both carried rounded to x_proj's dtype.  cs keeps
    the unrounded float32 c_t: the backward reads tanh(c_t) from it and
    rounds c_{t-1} itself."""
    t, d, b, four_h = x_proj.shape
    h = four_h // 4
    dtype = x_proj.dtype
    w = w_hh.to(dtype).float()
    h_prev = torch.zeros((d, b, h), dtype=dtype, device=x_proj.device)
    c_prev = h_prev
    hs, cs = [], []
    for step in range(t):
        gates = x_proj[step].float() + torch.bmm(h_prev.float(), w)
        i, f, g, o = gates.split(h, dim=-1)
        c = (torch.sigmoid(f) * c_prev.float()
             + torch.sigmoid(i) * torch.tanh(g))
        h_prev = (torch.sigmoid(o) * torch.tanh(c)).to(dtype)
        c_prev = c.to(dtype)
        hs.append(h_prev)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_scan_bwd_reference(x_proj, w_hh, hs, cs, dhs,
                            return_dgates: bool = False):
    """The backward of `lstm_scan_fwd_reference` as JAX differentiates
    mdd_tpu's scan: (x_proj, w_hh, hs, cs float32, dhs) -> (dx_proj,
    dW_hh), both in x_proj.dtype, and with `return_dgates` the float32
    dgates (T, 2, B, 4H) of every step as a third output.

    Walks t from T-1 down to 0.  The gates are recomputed from h_{t-1}
    (hs, zero at t = 0) as the forward computed them.  With rnd() the
    rounding to x_proj's dtype, in this order (the places JAX's jaxpr of
    the scan's transpose rounds, all else float32):

    1. dh = rnd(dhs_t + dh_carry), a sum of two cotangents in the dtype;
    2. with ef = sig(o) dh (1 - tanh c_t), where c_t is the unrounded
       float32 c: dc = (dc_carry + ef) + ef tanh c_t (tanh's derivative
       as autodiff writes it), and dc_carry' = rnd(sig(f) dc); c_{t-1}
       in the f gate's term is the rounded carry of the forward;
    3. dgates stay float32 in both products: dh_carry' = rnd(dgates @
       w_hh^T); dx_proj_t = rnd(dgates);
    4. dW_hh sums rnd(h_{t-1}^T @ dgates) in the dtype, from t = T-1
       down: acc = rnd(acc + rnd(product));
    5. dhs arrives in the dtype (the ys cotangent of the flip and concat
       is added there before the scan)."""
    t, d, b, four_h = x_proj.shape
    h = four_h // 4
    dtype = x_proj.dtype
    w = w_hh.to(dtype).float()
    w_t = w.transpose(1, 2)

    def rnd(a):
        return a.to(dtype).float()

    zeros = torch.zeros((d, b, h), dtype=torch.float32, device=x_proj.device)
    dh_carry, dc_carry = zeros, zeros
    dw = torch.zeros((d, h, four_h), dtype=dtype, device=x_proj.device)
    dxp = torch.empty_like(x_proj)
    all_dgates = torch.empty(x_proj.shape, dtype=torch.float32,
                             device=x_proj.device) if return_dgates else None
    for step in range(t - 1, -1, -1):
        h_prev = hs[step - 1].float() if step > 0 else zeros
        c_prev = rnd(cs[step - 1]) if step > 0 else zeros
        gates = x_proj[step].float() + torch.bmm(h_prev, w)
        i, f, g, o = gates.split(h, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        tanh_c = torch.tanh(cs[step].float())
        dh = rnd(dhs[step].float() + dh_carry)
        ef = o * dh * (1.0 - tanh_c)
        dc = (dc_carry + ef) + ef * tanh_c
        em = i * dc * (1.0 - g)
        dgates = torch.cat([dc * g * (i * (1.0 - i)),
                            dc * c_prev * (f * (1.0 - f)),
                            em + em * g,
                            dh * tanh_c * (o * (1.0 - o))], dim=-1)
        dxp[step] = dgates.to(dtype)
        if return_dgates:
            all_dgates[step] = dgates
        dh_carry = rnd(torch.bmm(dgates, w_t))
        dw = dw + torch.bmm(h_prev.transpose(1, 2), dgates).to(dtype)
        dc_carry = rnd(f * dc)
    return (dxp, dw, all_dgates) if return_dgates else (dxp, dw)


def bf16_split3(x: torch.Tensor):
    """float32 x -> (hi, mid, lo), bfloat16 tensors with hi + mid + lo == x
    exactly (summed in float32 in any order) wherever |x| >= 2^-110: hi is
    x cut to bfloat16's 8 significant bits, mid the remainder (exact in
    float32) cut likewise, lo what is left (at most 8 significant bits); a
    zero part takes x's sign, so -0 splits into three -0.  A float32 times
    a bfloat16 is then three exact products, as csrc/lstm_scan.cu's
    `split3` feeds its bfloat16 tensor-core passes."""
    high = torch.tensor(-65536, dtype=torch.int32, device=x.device)
    sign = x.view(torch.int32) & torch.tensor(
        -2 ** 31, dtype=torch.int32, device=x.device)
    hi = (x.view(torch.int32) & high).view(torch.float32)
    rest = ((x - hi).view(torch.int32) | sign).view(torch.float32)
    mid = (rest.view(torch.int32) & high).view(torch.float32)
    lo = ((rest - mid).view(torch.int32) | sign).view(torch.float32)
    return hi.bfloat16(), mid.bfloat16(), lo.bfloat16()


def lstm_scan_dw_reference(hs: torch.Tensor, dgates: torch.Tensor):
    """dW_hh of the scan contract in the order csrc/lstm_scan.cu computes
    it: (hs (T, 2, B, H) in the compute dtype, float32 dgates (T, 2, B, 4H))
    -> (2, H, 4H) in hs.dtype.  Every step's product rnd(h_{t-1}^T @
    dgates_t) at once (t >= 1; h_{-1} = 0 contributes nothing), then one
    ordered carry acc = rnd(acc + P_t) from t = T-1 down: equal bit for bit
    to `lstm_scan_bwd_reference`'s serial sum."""
    t, d, b, h = hs.shape
    dtype = hs.dtype
    dw = torch.zeros((d, h, dgates.shape[-1]), dtype=dtype, device=hs.device)
    if t < 2:
        return dw
    steps = torch.bmm(hs[:-1].float().reshape(-1, b, h).transpose(1, 2),
                      dgates[1:].reshape(-1, b, dgates.shape[-1]))
    steps = steps.to(dtype).reshape(t - 1, d, h, -1)
    for step in range(t - 2, -1, -1):
        dw = dw + steps[step]
    return dw


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
    #: the scan contract's instance (bfloat16 only, cs in float32)
    scan = False

    def cs_dtype(self, x_proj) -> torch.dtype:
        """The cs stream's dtype: the unrounded float32 c_t under the scan
        contract, else x_proj's (c rounded to it)."""
        return torch.float32 if self.scan else x_proj.dtype

    @property
    def argtypes(self):
        return (ctypes.c_void_p,) * self.n_pointers + (ctypes.c_int,) * 4

    def units_per_block(self) -> int:
        """Hidden units each block owns; H must be a multiple of it (a
        constant of the library, read once)."""
        if self.__dict__.get("_units") is None:
            units = getattr(self.library(), self.entry + "_units_per_block")
            units.argtypes = []
            units.restype = ctypes.c_int
            self._units = units()
        return self._units


#: one zeroed 128-byte line of counters per barrier group of the kernels
_COUNTER_STRIDE = 32
_ROWS_TILE = 16


def _barrier_counters(b: int, device) -> torch.Tensor:
    """Zeroed counters for every (direction, batch group) there can be.

    The caller holds the tensor until the launch is enqueued: freed any
    earlier (`_barrier_counters(...).data_ptr()` frees it at once), its
    block can go to an allocation of another thread whose copy lands
    before the kernel runs, and the kernel then starts from counts that
    are not zero (its barriers open early) and adds its counts to that
    thread's tensor.  After the launch the allocator's stream order makes
    the free safe."""
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
        fn = getattr(self.library(), self.entry + "_plan")
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
        cs = torch.empty_like(hs, dtype=self.cs_dtype(x_proj))
        counters = _barrier_counters(b, dev)   # held until enqueued
        self._launch(dev, x_proj.data_ptr(), w_hh.data_ptr(), hs.data_ptr(),
                     cs.data_ptr(), counters.data_ptr(), t, b, h,
                     _DTYPE_CODES[x_proj.dtype])
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
        fn = getattr(self.library(), self.entry + "_plan")
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
                               ("cs", cs, self.cs_dtype(x_proj)),
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
        """Launch the kernels that `parts` names into `buffers` (as
        `buffers()` makes them).  A part reads what the earlier ones left
        there; anything but ALL exists to time the launches one by one."""
        self._enqueue(x_proj, w_hh, hs, cs, dhs, buffers, parts,
                      *self._check(x_proj, w_hh, hs, cs, dhs))

    def _enqueue(self, x_proj, w_hh, hs, cs, dhs, buffers, parts, t, b, h):
        counters = _barrier_counters(b, x_proj.device)  # held until enqueued
        self._launch(x_proj.device, x_proj.data_ptr(), w_hh.data_ptr(),
                     hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
                     *(a.data_ptr() for a in buffers), counters.data_ptr(),
                     t, b, h, _DTYPE_CODES[x_proj.dtype], parts)

    def __call__(self, x_proj, w_hh, hs, cs, dhs):
        self._check(x_proj, w_hh, hs, cs, dhs)
        buffers = self.buffers(x_proj)
        self.run_parts(x_proj, w_hh, hs, cs, dhs, buffers, self.ALL)
        return buffers[0], buffers[1]


def _check_scan_dtype(x_proj, w_hh) -> None:
    """The scan kernels take bfloat16 only: in float32 the two contracts
    are one, and the Pallas contract's kernels take it.  Checked before
    anything is built."""
    if x_proj.dtype != torch.bfloat16 or w_hh.dtype != torch.bfloat16:
        raise TypeError("the scan-contract LSTM kernels take bfloat16 "
                        f"x_proj and w_hh, got {x_proj.dtype} and "
                        f"{w_hh.dtype}")


#: the plan entries of csrc/lstm_scan.cu: a recurrence's layout ...
_SCAN_PLAN = ("unit_groups", "tiles_per_block", "blocks", "smem_bytes",
              "chunk_rows", "launches")
#: ... and the backward's scratch and dW_hh layout after it
_SCAN_BWD_PLAN = _SCAN_PLAN + ("exchange_elems", "dw_steps_per_block",
                               "dw_carry_in_block", "dw_scratch_elems")


def _scan_plan(kernel, args: tuple, names: tuple, what: str) -> dict:
    """The plan entry's answer for `args` on the current device, asked once
    a process: it depends on nothing else (the wrapper reads it every
    backward, where a small call is host-bound)."""
    plans = kernel.__dict__.setdefault("_plans", {})
    key = (torch.cuda.current_device(), args)
    if key not in plans:
        fn = getattr(kernel.library(), kernel.entry + "_plan")
        fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * len(names))()
        err = fn(*args, out)
        if err != 0:
            raise ValueError(f"{what} has no layout for {args}: "
                             + kernel.library().mdd_cuda_error_string(
                                 err).decode())
        plans[key] = dict(zip(names, out))
    return dict(plans[key])


class LstmScanFwdKernel(LstmFwdKernel):
    """`mdd_lstm_scan_fwd` of csrc/lstm_scan.cu, the scan contract in
    bfloat16: (x_proj, w_hh) -> (hs, cs float32, the unrounded c_t)."""

    source, entry, scan = "lstm_scan.cu", "mdd_lstm_scan_fwd", True

    def plan(self, b: int, h: int, dtype: torch.dtype) -> dict:
        """How the kernel lays a batch of b rows out on the current card:
        unit groups of 8 and 16-row tiles a block owns, blocks and shared
        bytes of a launch, batch rows a launch, launches a call."""
        return _scan_plan(self, (b, h, _DTYPE_CODES[dtype]), _SCAN_PLAN,
                          "lstm_scan_fwd")

    def __call__(self, x_proj: torch.Tensor, w_hh: torch.Tensor):
        _check_scan_dtype(x_proj, w_hh)
        return super().__call__(x_proj, w_hh)


class LstmScanBwdKernel(LstmBwdKernel):
    """`mdd_lstm_scan_bwd` of csrc/lstm_scan.cu, the scan contract in
    bfloat16: (x_proj, w_hh, hs, cs float32, dhs float32) -> (dx_proj,
    dW_hh), both bfloat16.  Inside: the gate pre-activations as one
    product, the recurrence (the float32 dgates kept for the next part),
    every step's dW_hh product at once and their ordered bfloat16 carry;
    one count a backward."""

    source, entry, scan = "lstm_scan.cu", "mdd_lstm_scan_bwd", True
    n_pointers = 12

    def plan(self, t: int, b: int, h: int, dtype: torch.dtype) -> dict:
        """The recurrence's layout as `LstmScanFwdKernel.plan` gives it,
        the float32 elements of its exchange, the steps a dW_hh block
        walks, whether one block a tile carries dW_hh in registers (then
        no step scratch) and the bfloat16 elements of that scratch."""
        return _scan_plan(self, (t, b, h, _DTYPE_CODES[dtype]),
                          _SCAN_BWD_PLAN, "lstm_scan_bwd")

    def _check(self, x_proj, w_hh, hs, cs, dhs):
        _check_scan_dtype(x_proj, w_hh)
        return super()._check(x_proj, w_hh, hs, cs, dhs)

    def buffers(self, x_proj) -> tuple:
        """(dx_proj, dW_hh, z, dgates, exchange, dW_hh step scratch) for a
        call on x_proj: the bfloat16 outputs, the float32 gate
        pre-activations and dgates (T, 2, B, 4H) each, the float32 partial
        dh of the recurrence and the bfloat16 step products of dW_hh
        (T-1, 2, H, 4H) unless one block a tile carries it."""
        t, _, b, four_h = x_proj.shape
        h, dev = four_h // 4, x_proj.device
        if dev.index in (None, torch.cuda.current_device()):
            plan = self.plan(t, b, h, x_proj.dtype)
        else:
            with torch.cuda.device(dev):
                plan = self.plan(t, b, h, x_proj.dtype)
        f32 = dict(dtype=torch.float32, device=dev)
        return (torch.empty_like(x_proj),
                torch.empty((2, h, four_h), dtype=x_proj.dtype, device=dev),
                torch.empty((t, 2, b, four_h), **f32),
                torch.empty((t, 2, b, four_h), **f32),
                torch.empty(plan["exchange_elems"], **f32),
                torch.empty(plan["dw_scratch_elems"], dtype=x_proj.dtype,
                            device=dev))

    def __call__(self, x_proj, w_hh, hs, cs, dhs):
        shape = self._check(x_proj, w_hh, hs, cs, dhs)   # checked once
        buffers = self.buffers(x_proj)
        self._enqueue(x_proj, w_hh, hs, cs, dhs, buffers, self.ALL, *shape)
        return buffers[0], buffers[1]


#: the process's bindings; chip_smoke.py reads and resets their counters
lstm_fwd_kernel = LstmFwdKernel()
lstm_bwd_kernel = LstmBwdKernel()
lstm_scan_fwd_kernel = LstmScanFwdKernel()
lstm_scan_bwd_kernel = LstmScanBwdKernel()


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


def _bilstm(recurrence, x, w_ih_fwd, w_hh_fwd, w_ih_bwd, w_hh_bwd, b_fwd,
            b_bwd) -> torch.Tensor:
    """(T, B, D) -> (T, B, 2H): the two directions' projections stacked
    along axis 1, `recurrence` over them, the backward half flipped back."""
    x_proj = projections(x, w_ih_fwd, w_ih_bwd, b_fwd, b_bwd)
    hs = recurrence(x_proj, torch.stack([w_hh_fwd, w_hh_bwd]))
    return torch.cat([hs[:, 0], torch.flip(hs[:, 1], (0,))],
                     dim=-1).to(x.dtype)


def bilstm_cuda(x, w_ih_fwd, w_hh_fwd, w_ih_bwd, w_hh_bwd,
                b_fwd=None, b_bwd=None) -> torch.Tensor:
    """Drop-in for ops.lstm.bilstm over (T, B, D) -> (T, B, 2H), with the
    recurrence in `lstm_seq` (counterpart of bilstm_pallas)."""
    return _bilstm(lstm_seq, x, w_ih_fwd, w_hh_fwd, w_ih_bwd, w_hh_bwd,
                   b_fwd, b_bwd)


def lstm_scan_fwd(x_proj: torch.Tensor, w_hh: torch.Tensor):
    """(T, 2, B, 4H), (2, H, 4H) -> (hs, cs float32) under the scan
    contract: the kernel on a CUDA tensor (bfloat16 only), the plain
    version on a CPU tensor.  w_hh is cast to x_proj's dtype, as mdd_tpu's
    model casts its parameters."""
    w_hh = w_hh.to(x_proj.dtype)
    if x_proj.device.type == "cpu":
        return lstm_scan_fwd_reference(x_proj, w_hh)
    return lstm_scan_fwd_kernel(x_proj.contiguous(), w_hh.contiguous())


def lstm_scan_bwd(x_proj, w_hh, hs, cs, dhs):
    """-> (dx_proj, dW_hh), both in x_proj.dtype: the kernels on a CUDA
    tensor (bfloat16 only), the plain version on a CPU tensor.  dhs is
    rounded to x_proj's dtype (the dtype of JAX's cotangent of hs) and
    widened to float32 for the kernels, which is exact."""
    w_hh = w_hh.to(x_proj.dtype)
    dhs = dhs.to(x_proj.dtype)
    if x_proj.device.type == "cpu":
        return lstm_scan_bwd_reference(x_proj, w_hh, hs, cs, dhs)
    return lstm_scan_bwd_kernel(*(a.contiguous() for a in
                                  (x_proj, w_hh, hs, cs, dhs.float())))


class LstmScan(torch.autograd.Function):
    """lstm_scan with its hand-written backward (JAX's autodiff of
    mdd_tpu's scan): the forward saves (x_proj, w_hh, hs, cs), the backward
    returns (dx_proj in x_proj.dtype, dW_hh in w_hh.dtype)."""

    @staticmethod
    def forward(ctx, x_proj, w_hh):
        hs, cs = lstm_scan_fwd(x_proj, w_hh)
        ctx.save_for_backward(x_proj, w_hh, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        x_proj, w_hh, hs, cs = ctx.saved_tensors
        dxp, dw = lstm_scan_bwd(x_proj, w_hh, hs, cs, dhs)
        return dxp.to(x_proj.dtype), dw.to(w_hh.dtype)


def lstm_scan(x_proj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """(T, 2, B, 4H) projections + (2, H, 4H) recurrent weights ->
    (T, 2, B, H) hidden states under the scan contract, differentiable in
    both."""
    return LstmScan.apply(x_proj, w_hh)


def bilstm_scan_cuda(x, w_ih_fwd, w_hh_fwd, w_ih_bwd, w_hh_bwd,
                     b_fwd=None, b_bwd=None) -> torch.Tensor:
    """Drop-in for ops.lstm.bilstm over (T, B, D) -> (T, B, 2H), with the
    recurrence in `lstm_scan`: the same function and gradients as the
    plain loop, in mdd_tpu/ops/lstm.py's roundings."""
    return _bilstm(lstm_scan, x, w_ih_fwd, w_hh_fwd, w_ih_bwd, w_hh_bwd,
                   b_fwd, b_bwd)
