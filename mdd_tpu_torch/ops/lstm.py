"""LSTM recurrence in plain PyTorch (counterpart of mdd_tpu/ops/lstm.py).

The input projection x_t @ W_ih for all timesteps is one matmul outside
the loop; the loop does only the recurrent (B, H) @ (H, 4H) product and
the gate math.  Both directions of a BiLSTM run in one loop over a
(2, B, H) state, the backward direction on the time-reversed sequence.
Gate order (i, f, g, o) follows torch.nn.LSTM; padded steps run through
the recurrence like in the reference (no sequence packing).  Like the
scan it mirrors, this path carries h and c in the input's dtype.

`projections`, which all three recurrences take their inputs from,
chooses the input projections' products by dtype.  bfloat16 operands go
through `Bf16Projections`: bfloat16 x bfloat16 products accumulated and
returned in float32, which on the card are cuBLAS's bfloat16 tensor-core
products.  A product of two bfloat16 values is exact in float32, so these
are the float32 route's products, summed in another order.  Any other
dtype takes the float32 SGEMMs of `input_projections`.  The trace
counters `proj.bf16_products` and `proj.f32_products` count the products
each route runs, its backward's included.
"""

from __future__ import annotations

import torch

from mdd_tpu_torch.utils import trace


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 accumulation and result, for any operand dtype
    (jnp.dot(..., preferred_element_type=float32))."""
    return torch.matmul(a.float(), b.float())


def _f32_projection(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """_dot_f32(x, w), counted with the products of its backward."""
    out = _dot_f32(x, w)
    trace.count("proj.f32_products", 1)
    if out.requires_grad:
        n = int(x.requires_grad) + int(w.requires_grad)
        out.register_hook(lambda g: trace.count("proj.f32_products", n))
    return out


def input_projections(x, w_ih_fwd, w_ih_bwd):
    """(T, B, D) -> float32 (T, B, 4H) projections of x and of x reversed
    in time, as float32 products."""
    return (_f32_projection(x, w_ih_fwd),
            _f32_projection(torch.flip(x, (0,)), w_ih_bwd))


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bfloat16 matrices, accumulated and returned in float32:
    the bfloat16 tensor cores on the card, the float32 upcast elsewhere."""
    trace.count("proj.bf16_products", 1)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class Bf16Projections(torch.autograd.Function):
    """`projections` of bfloat16 operands, with the float32 route's
    roundings: each direction's product plus its bias in float32, rounded
    once into the (T, 2, B, 4H) bfloat16 result.

    The forward saves x's rows in time order and reversed, in bfloat16.
    The cotangent is bfloat16, and the float32 route's is its exact
    widening, since that route rounds the projections to bfloat16 too.
    The backward rounds each direction's dX and dW_ih to bfloat16 and sums
    the two dX in bfloat16, as autograd does on the float32 route; a bias
    gradient is a float32 sum over (T, B), then rounded."""

    @staticmethod
    def forward(ctx, x, w_ih_fwd, w_ih_bwd, b_fwd, b_bwd):
        t, b, d = x.shape
        rows = x.reshape(t * b, d)
        rows_rev = torch.flip(rows.view(t, b, d), (0,)).view(t * b, d)
        out = x.new_empty((t, 2, b, w_ih_fwd.shape[1]))
        for k, (xk, w, bias) in enumerate(((rows, w_ih_fwd, b_fwd),
                                           (rows_rev, w_ih_bwd, b_bwd))):
            p = _mm_f32(xk, w)
            if bias is not None:
                p += bias
            out[:, k] = p.view(t, b, -1)
        ctx.save_for_backward(rows, rows_rev, w_ih_fwd, w_ih_bwd)
        return out

    @staticmethod
    def backward(ctx, g):
        rows, rows_rev, w_ih_fwd, w_ih_bwd = ctx.saved_tensors
        t, _, b, four_h = g.shape
        need_x, need_wf, need_wb, need_bf, need_bb = ctx.needs_input_grad
        gf, gb = (g[:, k].reshape(t * b, four_h) for k in range(2))
        bf16 = torch.bfloat16
        dx = dw_f = dw_b = db_f = db_b = None
        if need_x:
            dx = (_mm_f32(gf, w_ih_fwd.t()).to(bf16).view(t, b, -1)
                  + torch.flip(_mm_f32(gb, w_ih_bwd.t()).to(bf16).view(
                      t, b, -1), (0,)))
        if need_wf:
            dw_f = _mm_f32(rows.t(), gf).to(bf16)
        if need_wb:
            dw_b = _mm_f32(rows_rev.t(), gb).to(bf16)
        if need_bf or need_bb:
            g32 = g.float()
            if need_bf:
                db_f = g32[:, 0].sum((0, 1)).to(bf16)
            if need_bb:
                db_b = g32[:, 1].sum((0, 1)).to(bf16)
        return dx, dw_f, dw_b, db_f, db_b


def projections(x, w_ih_fwd, w_ih_bwd, b_fwd=None, b_bwd=None):
    """(T, B, D) -> (T, 2, B, 4H) in x's dtype: the projections of x and
    of x reversed in time, each plus its bias in float32 and rounded once.
    bfloat16 operands take `Bf16Projections`, any other dtype the float32
    products of `input_projections`."""
    if all(a is None or a.dtype == torch.bfloat16
           for a in (x, w_ih_fwd, w_ih_bwd, b_fwd, b_bwd)):
        return Bf16Projections.apply(x, w_ih_fwd, w_ih_bwd, b_fwd, b_bwd)
    xf, xb = input_projections(x, w_ih_fwd, w_ih_bwd)
    if b_fwd is not None:
        xf = xf + b_fwd
    if b_bwd is not None:
        xb = xb + b_bwd
    return torch.stack([xf, xb], dim=1).to(x.dtype)


def lstm_scan(x_proj: torch.Tensor, w_hh: torch.Tensor,
              h0: torch.Tensor | None = None,
              c0: torch.Tensor | None = None) -> torch.Tensor:
    """(T, B, 4H) projections, (H, 4H) weights -> (T, B, H) hidden states."""
    t, b, four_h = x_proj.shape
    h = four_h // 4
    dtype = x_proj.dtype
    hprev = (torch.zeros((b, h), dtype=dtype, device=x_proj.device)
             if h0 is None else h0)
    cprev = (torch.zeros((b, h), dtype=dtype, device=x_proj.device)
             if c0 is None else c0)
    hs = []
    for step in range(t):
        gates = x_proj[step] + _dot_f32(hprev, w_hh)
        i, f, g, o = gates.split(h, dim=-1)
        c = torch.sigmoid(f) * cprev + torch.sigmoid(i) * torch.tanh(g)
        hprev = (torch.sigmoid(o) * torch.tanh(c)).to(dtype)
        cprev = c.to(dtype)
        hs.append(hprev)
    return torch.stack(hs)


def bilstm(x, w_ih_fwd, w_hh_fwd, w_ih_bwd, w_hh_bwd,
           b_fwd=None, b_bwd=None) -> torch.Tensor:
    """Bidirectional LSTM over (T, B, D) -> (T, B, 2H), one fused loop."""
    stacked = projections(x, w_ih_fwd, w_ih_bwd, b_fwd, b_bwd)
    w_hh = torch.stack([w_hh_fwd, w_hh_bwd])              # (2, H, 4H)
    t, _, b, four_h = stacked.shape
    h = four_h // 4
    hprev = torch.zeros((2, b, h), dtype=x.dtype, device=x.device)
    cprev = hprev
    hs = []
    for step in range(t):
        gates = stacked[step] + torch.bmm(hprev.float(), w_hh.float())
        i, f, g, o = gates.split(h, dim=-1)
        c = torch.sigmoid(f) * cprev + torch.sigmoid(i) * torch.tanh(g)
        hprev = (torch.sigmoid(o) * torch.tanh(c)).to(x.dtype)
        cprev = c.to(x.dtype)
        hs.append(hprev)
    hs = torch.stack(hs)                                  # (T, 2, B, H)
    return torch.cat([hs[:, 0], torch.flip(hs[:, 1], (0,))], dim=-1)
