"""The `cnn_bilstm` family: `mdd_tpu_torch/models/ctc_model.py`'s model
(the recipe's CNN-RNN-CTC), with or without its canonical-phone branch.

Convolutions over (time, frequency), each with masked BatchNorm, ReLU
and dropout; `rnn_layers` BiLSTMs (gate order i, f, g, o; masked
BatchNorm before every layer but the first, dropout after each); with
`use_text_attention` the canonical-phone embedding, its BiLSTM (with
biases), a key projection and masked dot attention, whose context is
concatenated to the acoustic output; masked BatchNorm, the head and the
log-softmax.  The interface is families/__init__.py's.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from mdd_bench.reference import batch_norm, dropout, n_classes


def conv_out(cfg: dict, t: int, f: int):
    """(time, freq) after the convolutions."""
    for (kt, kf), (st, sf), (pt, pf) in zip(cfg["kernel_size"],
                                            cfg["stride"], cfg["padding"]):
        t = (t + 2 * pt - kt) // st + 1
        f = (f + 2 * pf - kf) // sf + 1
    return t, f


def input_dim(cfg: dict) -> int:
    return cfg["feature_dim"] * (cfg["left_ctx"] + 1 + cfg["right_ctx"])


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """The model's parameters by their published (flax path) names."""
    h = cfg["rnn_hidden_size"]
    shapes: Dict[str, tuple] = {}
    c_in = 1
    for i, ((_, ch), (kt, kf)) in enumerate(zip(cfg["channel"],
                                                cfg["kernel_size"])):
        shapes[f"conv.conv{i}.kernel"] = (ch, c_in, kt, kf)
        shapes[f"conv.conv{i}.bias"] = (ch,)
        shapes[f"conv.bn{i}.scale"] = (ch,)
        shapes[f"conv.bn{i}.bias"] = (ch,)
        c_in = ch
    _, f = conv_out(cfg, 1, input_dim(cfg))
    d_in = f * c_in
    for i in range(cfg["rnn_layers"]):
        if i > 0:
            shapes[f"rnn{i}.bn.scale"] = (d_in,)
            shapes[f"rnn{i}.bn.bias"] = (d_in,)
        for d in ("fwd", "bwd"):
            shapes[f"rnn{i}.w_ih_{d}"] = (d_in, 4 * h)
            shapes[f"rnn{i}.w_hh_{d}"] = (h, 4 * h)
        d_in = 2 * h
    head_in = 2 * h
    if cfg["use_text_attention"]:
        e = cfg["text_embed_size"]
        shapes["text.embed.embedding"] = (max(45, n_classes(cfg) + 2), e)
        for d in ("fwd", "bwd"):
            shapes[f"text.lstm.w_ih_{d}"] = (e, 4 * h)
            shapes[f"text.lstm.w_hh_{d}"] = (h, 4 * h)
        for d in ("fwd", "bwd"):
            shapes[f"text.lstm.b_{d}"] = (4 * h,)
        shapes["text.key_proj.kernel"] = (2 * h, 2 * h)
        head_in *= 2
    shapes["head_bn.scale"] = (head_in,)
    shapes["head_bn.bias"] = (head_in,)
    shapes["head.kernel"] = (head_in, n_classes(cfg))
    return shapes


def spread(name: str, shape: tuple, cfg: dict):
    """The recurrent weights and biases U(-1/sqrt(H), 1/sqrt(H)) as the
    recipe draws them; the convolution and dense kernels and the
    embedding uniform with the standard deviation of their lecun-normal
    and N(0, 1/features) initializers; BatchNorm at identity and the
    convolution biases at 0."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.startswith(("w_ih", "w_hh", "b_fwd", "b_bwd")):
        return cfg["rnn_hidden_size"] ** -0.5, 0.0
    if leaf == "kernel":
        fan_in = math.prod(shape[1:]) if len(shape) == 4 else shape[0]
        return math.sqrt(3.0 / fan_in), 0.0
    if leaf == "embedding":
        return math.sqrt(3.0 / shape[1]), 0.0
    if leaf == "scale":
        return 0.0, 1.0
    if leaf == "bias":
        return 0.0, 0.0
    raise ValueError(f"no initializer for parameter {name}")


def bilstm(q, x, w_ih_f, w_hh_f, w_ih_b, w_hh_b, b_f=None, b_b=None):
    """(T, B, D) -> (T, B, 2H): a forward LSTM and one over the reversed
    sequence, gates (i, f, g, o), zero initial state."""
    outs = []
    for w_ih, w_hh, bias, rev in ((w_ih_f, w_hh_f, b_f, False),
                                  (w_ih_b, w_hh_b, b_b, True)):
        xs = torch.flip(x, (0,)) if rev else x
        proj = q(xs) @ q(w_ih)
        if bias is not None:
            proj = proj + bias
        h_dim = w_hh.shape[0]
        h = x.new_zeros((x.shape[1], h_dim))
        c = x.new_zeros((x.shape[1], h_dim))
        wq = q(w_hh)
        hs = []
        for t in range(x.shape[0]):
            gates = proj[t] + q(h) @ wq
            i, f, g, o = gates.split(h_dim, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        hs = torch.stack(hs)
        outs.append(torch.flip(hs, (0,)) if rev else hs)
    return torch.cat(outs, dim=-1)


def forward(P: Dict[str, torch.Tensor], cfg: dict, x, trans, trsizes,
            valid, gens, q):
    """(B, T, 243) spliced features -> (T', B, C) log-probs, train mode."""
    rate = cfg["drop_out"]
    x = x[:, None]
    for i, (s, p) in enumerate(zip(cfg["stride"], cfg["padding"])):
        x = F.conv2d(q(x), q(P[f"conv.conv{i}.kernel"]), None,
                     stride=tuple(s), padding=tuple(p)) \
            + P[f"conv.conv{i}.bias"].view(-1, 1, 1)
        x = F.relu(batch_norm(x, P[f"conv.bn{i}.scale"],
                              P[f"conv.bn{i}.bias"], 1, valid))
        x = dropout(x, rate, gens)
    b, c, t, f = x.shape
    x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)
    for i in range(cfg["rnn_layers"]):
        if i > 0:
            x = batch_norm(x, P[f"rnn{i}.bn.scale"], P[f"rnn{i}.bn.bias"],
                           -1, valid)
        y = bilstm(q, x.transpose(0, 1), P[f"rnn{i}.w_ih_fwd"],
                   P[f"rnn{i}.w_hh_fwd"], P[f"rnn{i}.w_ih_bwd"],
                   P[f"rnn{i}.w_hh_bwd"])
        x = dropout(y.transpose(0, 1), rate, gens)
    if cfg["use_text_attention"]:
        mask = (torch.arange(trans.shape[1], device=trans.device)[None]
                < trsizes[:, None])
        emb = P["text.embed.embedding"][trans] * mask[..., None]
        values = bilstm(q, emb.transpose(0, 1), P["text.lstm.w_ih_fwd"],
                        P["text.lstm.w_hh_fwd"], P["text.lstm.w_ih_bwd"],
                        P["text.lstm.w_hh_bwd"], P["text.lstm.b_fwd"],
                        P["text.lstm.b_bwd"]).transpose(0, 1)
        keys = q(values) @ q(P["text.key_proj.kernel"])
        scores = torch.einsum("btd,bld->btl", q(x), q(keys))
        scores = scores.masked_fill(~mask[:, None, :], -1e30)
        context = torch.einsum("btl,blv->btv", torch.softmax(scores, -1),
                               q(values))
        x = torch.cat([x, context], dim=-1)
    x = batch_norm(x, P["head_bn.scale"], P["head_bn.bias"], -1, valid)
    logits = q(x) @ q(P["head.kernel"])
    return torch.log_softmax(logits, dim=-1).transpose(0, 1)


def ctc_sizes(cfg: dict, frames, t_in: int, t_out: int):
    """Each row's frames scaled by the convolutions' time stride."""
    return frames * t_out // t_in


def row_flops(cfg: dict, frames: int, label_len: int) -> float:
    """The matrix work of one row's forward (a frozen copy of
    `mdd_tpu_torch/bench.py`'s count): the convolutions, the BiLSTMs'
    input and recurrent products, the text branch and the head."""
    t, f = frames, input_dim(cfg)
    flops = 0.0
    cin = 1
    for (kt, kf), (st, sf), (pt, pf), (_, ch) in zip(
            cfg["kernel_size"], cfg["stride"], cfg["padding"],
            cfg["channel"]):
        t = (t + 2 * pt - kt) // st + 1
        f = (f + 2 * pf - kf) // sf + 1
        flops += 2.0 * t * f * ch * kt * kf * cin
        cin = ch
    t_out = t
    h = cfg["rnn_hidden_size"]
    d_in = f * cin
    for layer in range(cfg["rnn_layers"]):
        d = d_in if layer == 0 else 2 * h
        flops += 2.0 * t_out * 2 * (d * 4 * h + h * 4 * h)
    if cfg["use_text_attention"]:
        le = label_len
        e = cfg["text_embed_size"]
        flops += 2.0 * le * 2 * (e * 4 * h + h * 4 * h)
        flops += 2.0 * le * (2 * h) * (2 * h)
        flops += 2.0 * t_out * le * (2 * h) * 2
        head_in = 4 * h
    else:
        head_in = 2 * h
    flops += 2.0 * t_out * head_in * (len(cfg["units"]) + 2)
    return flops
