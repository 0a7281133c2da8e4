"""CNN + BiLSTM CTC acoustic model with canonical-text attention, in PyTorch.

Counterpart of mdd_tpu/models/ctc_model.py:

  acoustic:  (B, T, 243) spliced fbank
             -> Conv 3x3 s(1,2) + BN + ReLU + dropout      (32 ch)
             -> Conv 3x3 s(2,2) + BN + ReLU + dropout      (32 ch)
             -> flatten freq x channel -> 4 x BiLSTM(384) + dropout (BN
                before layers 2..4, no recurrent bias) -> (B, T', 768)
  text:      (B, L) canonical phone ids -> Embedding(512)
             -> BiLSTM(384) with bias -> values (B, L, 768)
             -> keys = values @ W_key (768 x 768)
  fusion:    masked dot attention; concat -> (B, T', 1536)
  head:      BN + Dense(num_class, no bias) -> log_softmax -> (T', B, C)

Parameters and buffers carry the flax module paths as their names
(`rnn0.w_ih_fwd`, `conv.bn0.mean`, `head.kernel`, ...) and the flax
orientation (`x @ kernel`); only the convolution kernels are stored in
torch's OIHW layout.  convert.flax_to_torch maps a flax checkpoint onto
them; `init_parameters` draws fresh ones with flax's initializers.

`forward(..., train=True, sample_mask=..., generator=...)` is flax's train
mode: every BatchNorm normalises with the statistics of the rows
`sample_mask` keeps and updates its running averages, and dropout masks
are drawn from `generator`.  With `use_fused_dropout` every dropout site
(the 2 convolution outputs and the 4 acoustic BiLSTM outputs) goes through
ops.dropout_cuda.fused_dropout: one seed from `generator` per site and
call, the mask made in the kernel on both passes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mdd_tpu_torch.ops.attention import dot_attention
from mdd_tpu_torch.ops.dropout_cuda import fused_dropout
from mdd_tpu_torch.ops.lstm import bilstm
from mdd_tpu_torch.ops.lstm_cuda import bilstm_cuda
from mdd_tpu_torch.parallel import mesh

BN_EPSILON = 1e-5    # flax.linen.BatchNorm's default
BN_MOMENTUM = 0.9    # mdd_tpu's BatchNorm(momentum=0.9): ra = 0.9 ra + 0.1 x


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    input_dim: int = 243               # spliced feature dim (81 * 3)
    num_class: int = 43                # vocab size (blank + UNK + phones)
    conv_channels: Tuple[int, ...] = (32, 32)
    conv_kernels: Tuple[Tuple[int, int], ...] = ((3, 3), (3, 3))
    conv_strides: Tuple[Tuple[int, int], ...] = ((1, 2), (2, 2))   # (time, freq)
    conv_padding: Tuple[Tuple[int, int], ...] = ((1, 1), (1, 1))
    rnn_hidden_size: int = 384
    rnn_layers: int = 4
    use_text_attention: bool = True
    text_embed_size: int = 512
    text_vocab_size: int = 45          # >= num_class (reference hardcodes 44)
    dropout: float = 0.2
    compute_dtype: str = "float32"     # "bfloat16" for throughput runs
    use_pallas_lstm: bool = False      # acoustic recurrence in the fused
    # kernels (mdd_tpu: Pallas; here: csrc/lstm_{fwd,bwd}.cu via
    # ops.lstm_cuda)
    use_fused_dropout: bool = False    # dropout masks made in the kernel
    # from a seed (mdd_tpu: Pallas; here: csrc/dropout.cu via
    # ops.dropout_cuda); the backward regenerates the mask from the seed

    @property
    def time_downsample(self) -> int:
        d = 1
        for s in self.conv_strides:
            d *= s[0]
        return d

    @property
    def encoder_dim(self) -> int:
        return 2 * self.rnn_hidden_size

    def conv_output_dim(self) -> int:
        f = self.input_dim
        for (kt, kf), (st, sf), (pt, pf) in zip(
                self.conv_kernels, self.conv_strides, self.conv_padding):
            f = (f + 2 * pf - kf) // sf + 1
        return f * self.conv_channels[-1]

    def output_frames(self, t_in: int) -> int:
        t = t_in
        for (kt, _), (st, _), (pt, _) in zip(
                self.conv_kernels, self.conv_strides, self.conv_padding):
            t = (t + 2 * pt - kt) // st + 1
        return t


def model_config_from_meta(meta: dict) -> ModelConfig:
    """ModelConfig from a checkpoint's `.meta.json` (lists -> tuples)."""
    raw = dict(meta["model_config"])
    for k in ("conv_channels", "conv_kernels", "conv_strides",
              "conv_padding"):
        if k in raw:
            raw[k] = tuple(tuple(e) if isinstance(e, list) else e
                           for e in raw[k])
    return ModelConfig(**raw)


def batch_stats(x: torch.Tensor, axis: int,
                sample_mask: torch.Tensor | None):
    """flax's BatchNorm statistics over every axis but `axis`, leaving out
    the batch rows (axis 0) where `sample_mask` is False: float32 mean and
    the fast variance E[x^2] - E[x]^2, clamped at 0 (use_fast_variance).

    In a process group of several ranks the rows are those of the global
    batch, as under mdd_tpu's mesh: the masked sums (x, x^2, count) are
    summed over the ranks by a differentiable all-reduce, so the
    statistics and the gradients through them are the global batch's.  A
    rank whose rows are all masked (a batch smaller than the ranks, a
    short last batch) adds exact zeros, whatever its padding rows hold."""
    xf = x.float()
    dims = [k for k in range(x.dim()) if k != axis % x.dim()]
    if sample_mask is None and mesh.process_count() == 1:
        mean, mean2 = xf.mean(dims), (xf * xf).mean(dims)
    else:
        keep = (torch.ones_like(xf, dtype=torch.bool) if sample_mask is None
                else sample_mask.view([-1] + [1] * (x.dim() - 1)
                                      ).expand_as(xf))
        kept = torch.where(keep, xf, torch.zeros((), dtype=xf.dtype,
                                                 device=xf.device))
        sums = mesh.all_reduce_sum(torch.stack([
            kept.sum(dims), (kept * kept).sum(dims),
            keep.sum(dims).to(xf.dtype)]))
        mean, mean2 = sums[0] / sums[2], sums[1] / sums[2]
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


class BatchNorm(nn.Module):
    """BatchNorm with flax's parameter names and arithmetic:
    (x - mean) * (scale * rsqrt(var + eps)) + bias, over one feature axis.

    Eval mode normalises with the running averages.  Train mode normalises
    with the batch statistics of the rows `sample_mask` keeps
    (`batch_stats`, over every rank's rows in a process group) and moves
    the running averages towards them, ra = 0.9 ra + 0.1 batch, with the
    biased variance, as flax does."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype, axis: int = -1,
                train: bool = False,
                sample_mask: torch.Tensor | None = None) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[axis] = -1
        if train:
            mean, var = batch_stats(x, axis, sample_mask)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean
                                + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var
                               + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPSILON) * self.scale
        y = (x - mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(dtype)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: torch.Generator | None,
            fused: bool = False) -> torch.Tensor:
    """flax nn.Dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate); the mask comes from
    `generator`, which train mode must supply when rate > 0.  `fused`
    (mdd_tpu's _Dropout(fused=True)) draws only a seed from it and makes
    the mask inside the fused dropout kernel."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout draws its masks from an "
                         "explicit torch.Generator; pass generator=")
    if fused:
        return fused_dropout(x, rate, generator)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class Dense(nn.Module):
    """x @ kernel, no bias; kernel is (in, out) as in flax."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return torch.matmul(x.to(dtype), self.kernel.to(dtype))


class BiLstmLayer(nn.Module):
    """BatchNorm -> BiLSTM (reference BatchRNN, model_ctc.py:15-49)."""

    def __init__(self, d_in: int, hidden_size: int,
                 use_batch_norm: bool = True, use_bias: bool = False,
                 use_kernel: bool = False, dropout: float = 0.0,
                 fused_dropout: bool = False):
        super().__init__()
        four_h = 4 * hidden_size
        self.dropout = dropout
        self.fused_dropout = fused_dropout
        self.bn = BatchNorm(d_in) if use_batch_norm else None
        self.w_ih_fwd = nn.Parameter(torch.empty(d_in, four_h))
        self.w_hh_fwd = nn.Parameter(torch.empty(hidden_size, four_h))
        self.w_ih_bwd = nn.Parameter(torch.empty(d_in, four_h))
        self.w_hh_bwd = nn.Parameter(torch.empty(hidden_size, four_h))
        self.b_fwd = self.b_bwd = None
        if use_bias:
            self.b_fwd = nn.Parameter(torch.empty(four_h))
            self.b_bwd = nn.Parameter(torch.empty(four_h))
        self.rnn = bilstm_cuda if use_kernel else bilstm

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                train: bool = False, sample_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        # x: (B, T, D) -> (B, T, 2H)
        if self.bn is not None:
            x = self.bn(x, dtype, train=train, sample_mask=sample_mask)
        w = [p.to(dtype) for p in (self.w_ih_fwd, self.w_hh_fwd,
                                   self.w_ih_bwd, self.w_hh_bwd)]
        b = [None if p is None else p.to(dtype)
             for p in (self.b_fwd, self.b_bwd)]
        y = self.rnn(x.transpose(0, 1), *w, *b)                  # (T, B, 2H)
        if self.fused_dropout:
            # the kernel indexes flat contiguous memory: drop the
            # time-major tensor the recurrence returns, not its transposed
            # view (the mask is independent per element, so the order of
            # the two does not matter to the law)
            return dropout(y, self.dropout, train, generator,
                           fused=True).transpose(0, 1)
        return dropout(y.transpose(0, 1), self.dropout, train, generator)


class ConvSubsampler(nn.Module):
    """Stacked Conv2d + BN + ReLU; (B, T, F) -> (B, T', F' * C)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        c_in = 1
        for i, (ch, (kt, kf)) in enumerate(zip(cfg.conv_channels,
                                               cfg.conv_kernels)):
            conv = nn.Module()
            conv.kernel = nn.Parameter(torch.empty(ch, c_in, kt, kf))  # OIHW
            conv.bias = nn.Parameter(torch.zeros(ch))
            self.add_module(f"conv{i}", conv)
            self.add_module(f"bn{i}", BatchNorm(ch))
            c_in = ch

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                train: bool = False, sample_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x[:, None].to(dtype)                            # NCHW, C = 1
        for i, (s, p) in enumerate(zip(self.cfg.conv_strides,
                                       self.cfg.conv_padding)):
            conv = getattr(self, f"conv{i}")
            # the bias is added after the product is rounded to `dtype`, as
            # flax's Conv adds it: in bfloat16 a fused bias rounds once
            # where flax rounds twice
            x = F.conv2d(x, conv.kernel.to(dtype), None, stride=tuple(s),
                         padding=tuple(p)) + conv.bias.to(dtype).view(-1, 1, 1)
            x = F.relu(getattr(self, f"bn{i}")(
                x, dtype, axis=1, train=train, sample_mask=sample_mask))
            x = dropout(x, self.cfg.dropout, train, generator,
                        fused=self.cfg.use_fused_dropout)
        b, c, t, f = x.shape
        # flax flattens NHWC: frequency-major, channel fastest
        return x.permute(0, 2, 3, 1).reshape(b, t, f * c)


class TextEncoder(nn.Module):
    """Canonical-phone encoder: Embedding -> BiLSTM -> (values, keys).

    The text BiLSTM stays on the plain loop, as in mdd_tpu (short L), and
    has no BatchNorm and no dropout, so train mode changes nothing here."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.embed = nn.Module()
        self.embed.embedding = nn.Parameter(
            torch.empty(cfg.text_vocab_size, cfg.text_embed_size))
        self.lstm = BiLstmLayer(cfg.text_embed_size, cfg.rnn_hidden_size,
                                use_batch_norm=False, use_bias=True)
        self.key_proj = Dense(cfg.encoder_dim, cfg.encoder_dim)

    def forward(self, trans: torch.Tensor, trans_lengths, dtype):
        emb = self.embed.embedding.to(dtype)[trans]
        if trans_lengths is not None:
            # zero padded positions so the backward direction cannot leak
            # padding content into valid states
            valid = (torch.arange(trans.shape[1], device=trans.device)[None]
                     < trans_lengths[:, None])
            emb = torch.where(valid[:, :, None], emb, torch.zeros_like(emb))
        values = self.lstm(emb, dtype)
        return values, self.key_proj(values, dtype)


class CTCAttentionModel(nn.Module):
    """The flagship model: returns (T', B, num_class) float32 log-probs."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.conv = ConvSubsampler(cfg)
        d_in = cfg.conv_output_dim()
        self.rnn_layers = []
        for i in range(cfg.rnn_layers):
            layer = BiLstmLayer(d_in, cfg.rnn_hidden_size,
                                use_batch_norm=i > 0,
                                use_kernel=cfg.use_pallas_lstm,
                                dropout=cfg.dropout,
                                fused_dropout=cfg.use_fused_dropout)
            self.add_module(f"rnn{i}", layer)
            self.rnn_layers.append(layer)
            d_in = cfg.encoder_dim
        head_in = cfg.encoder_dim
        if cfg.use_text_attention:
            self.text = TextEncoder(cfg)
            head_in *= 2
        self.head_bn = BatchNorm(head_in)
        self.head = Dense(head_in, cfg.num_class)

    def forward(self, feats: torch.Tensor, trans: torch.Tensor,
                trans_lengths: torch.Tensor | None = None,
                train: bool = False,
                sample_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """sample_mask: (B,) bool, False rows (batch padding) are left out
        of the batch statistics; generator: the dropout masks' source."""
        rest = dict(train=train, sample_mask=sample_mask,
                    generator=generator)
        x = self.conv(feats, self.dtype, **rest)
        for layer in self.rnn_layers:
            x = layer(x, self.dtype, **rest)                # (B, T', 768)
        if self.cfg.use_text_attention:
            values, keys = self.text(trans, trans_lengths, self.dtype)
            mask = None
            if trans_lengths is not None:
                mask = (torch.arange(trans.shape[1], device=trans.device)[None]
                        < trans_lengths[:, None])
            context, _ = dot_attention(x, keys, values, mask)
            x = torch.cat([x, context], dim=-1)             # (B, T', 1536)
        x = self.head_bn(x, self.dtype, train=train, sample_mask=sample_mask)
        logits = self.head(x, self.dtype).float()
        return torch.log_softmax(logits, dim=-1).transpose(0, 1)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Fresh weights with mdd_tpu's initializers (the distributions of
        flax's defaults, not its random bits): LSTM weights and biases
        U(-1/sqrt(H), 1/sqrt(H)), convolution and dense kernels
        lecun-normal, convolution biases 0, embeddings N(0, 1/features),
        BatchNorm at identity."""
        lim = self.cfg.rnn_hidden_size ** -0.5
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith(("w_ih", "w_hh", "b_fwd", "b_bwd")):
                p.uniform_(-lim, lim, generator=generator)
            elif leaf == "kernel":
                fan_in = p[0].numel() if p.dim() == 4 else p.shape[0]
                std = fan_in ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
            elif leaf == "embedding":
                p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
            elif leaf in ("bias", "scale"):
                p.fill_(1.0 if leaf == "scale" else 0.0)
            else:
                raise ValueError(f"no initializer for parameter {name}")
        for name, buf in self.named_buffers():
            buf.fill_(1.0 if name.endswith(".var") else 0.0)
