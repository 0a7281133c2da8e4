"""Weight bridge: flax parameter trees -> the port's state_dict.

mdd_tpu checkpoints hold two nested dicts, `params` and `batch_stats`,
laid out by flax module path (`rnn0/w_ih_fwd`, `conv/bn0/mean`, ...).
The port's modules carry the same paths as their names, so the bridge is
a renaming ('/' -> '.') plus one layout change: convolution kernels go
from flax HWIO to torch OIHW.  Every leaf must map and none may be left
over.  The numpy arrays come from the port's own reader of mdd_tpu's
orbax files (train/orbax_format.py, which needs no JAX or orbax), or
from orbax itself in a process that has it.

`random_flax_variables` makes seeded weights in the same flax layout, so
a full-width model can be run without a trained checkpoint.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from mdd_tpu_torch.models.ctc_model import ModelConfig

_LSTM = ("w_ih_fwd", "w_hh_fwd", "w_ih_bwd", "w_hh_bwd")


def _flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _count(keys: Iterable[str], pattern: str) -> int:
    """1 + the largest index of the top-level names matching pattern."""
    idx = [int(m.group(1)) for k in keys if (m := re.fullmatch(pattern, k))]
    return max(idx) + 1 if idx else 0


def _expected_leaves(n_conv: int, n_rnn: int,
                     text: bool) -> Tuple[set, set]:
    params, stats = set(), set()
    for i in range(n_conv):
        params |= {f"conv/conv{i}/kernel", f"conv/conv{i}/bias",
                   f"conv/bn{i}/scale", f"conv/bn{i}/bias"}
        stats |= {f"conv/bn{i}/mean", f"conv/bn{i}/var"}
    for i in range(n_rnn):
        params |= {f"rnn{i}/{w}" for w in _LSTM}
        if i > 0:
            params |= {f"rnn{i}/bn/scale", f"rnn{i}/bn/bias"}
            stats |= {f"rnn{i}/bn/mean", f"rnn{i}/bn/var"}
    if text:
        params |= {"text/embed/embedding", "text/key_proj/kernel",
                   "text/lstm/b_fwd", "text/lstm/b_bwd"}
        params |= {f"text/lstm/{w}" for w in _LSTM}
    params |= {"head_bn/scale", "head_bn/bias", "head/kernel"}
    stats |= {"head_bn/mean", "head_bn/var"}
    return params, stats


def flax_to_torch(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """Nested numpy dicts laid out as an mdd_tpu checkpoint -> state_dict
    for CTCAttentionModel.  Raises ValueError on a missing or unknown leaf."""
    flat_p, flat_s = _flatten(params), _flatten(batch_stats)
    n_conv = _count(params.get("conv", {}), r"conv(\d+)")
    n_rnn = _count(params, r"rnn(\d+)")
    want_p, want_s = _expected_leaves(n_conv, n_rnn, "text" in params)
    problems = []
    for what, have, want in (("params", flat_p, want_p),
                             ("batch_stats", flat_s, want_s)):
        if missing := sorted(want - have.keys()):
            problems.append(f"{what} missing {missing}")
        if unknown := sorted(have.keys() - want):
            problems.append(f"{what} has unknown leaves {unknown}")
    if problems:
        raise ValueError("flax -> torch bridge: " + "; ".join(problems))
    state = {}
    for path, value in list(flat_p.items()) + list(flat_s.items()):
        if re.fullmatch(r"conv/conv\d+/kernel", path):
            value = value.transpose(3, 2, 0, 1)              # HWIO -> OIHW
        # a copy: the caller's arrays may be read-only views
        state[path.replace("/", ".")] = torch.from_numpy(
            np.array(value, dtype=np.float32, order="C"))
    return state


def random_flax_variables(cfg: ModelConfig, seed: int):
    """Seeded numpy weights for `cfg` in the mdd_tpu checkpoint layout:
    (params, batch_stats).  Scales follow the flax initializers (LSTM
    uniform +-1/sqrt(H), lecun-normal kernels); the batch-norm statistics
    and affine terms are drawn away from identity so the bridge's mapping
    of each is exercised."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(f32)

    def bn(n):
        return ({"scale": rng.uniform(0.8, 1.2, n).astype(f32),
                 "bias": normal(n, 0.1)},
                {"mean": normal(n, 0.1),
                 "var": rng.uniform(0.5, 1.5, n).astype(f32)})

    def lstm(d_in, h, bias=False):
        s = 1.0 / np.sqrt(h)
        out = {}
        for w in _LSTM:
            rows = d_in if "ih" in w else h
            out[w] = rng.uniform(-s, s, (rows, 4 * h)).astype(f32)
        if bias:
            out["b_fwd"] = rng.uniform(-s, s, 4 * h).astype(f32)
            out["b_bwd"] = rng.uniform(-s, s, 4 * h).astype(f32)
        return out

    params: dict = {"conv": {}}
    stats: dict = {"conv": {}}
    c_in = 1
    for i, (ch, (kt, kf)) in enumerate(zip(cfg.conv_channels,
                                           cfg.conv_kernels)):
        params["conv"][f"conv{i}"] = {
            "kernel": normal((kt, kf, c_in, ch), np.sqrt(1.0 / (kt * kf * c_in))),
            "bias": normal(ch, 0.01)}
        params["conv"][f"bn{i}"], stats["conv"][f"bn{i}"] = bn(ch)
        c_in = ch
    h = cfg.rnn_hidden_size
    d_in = cfg.conv_output_dim()
    for i in range(cfg.rnn_layers):
        params[f"rnn{i}"] = lstm(d_in, h)
        if i > 0:
            p_bn, s_bn = bn(d_in)
            params[f"rnn{i}"]["bn"] = p_bn
            stats[f"rnn{i}"] = {"bn": s_bn}
        d_in = cfg.encoder_dim
    head_in = cfg.encoder_dim
    if cfg.use_text_attention:
        e = cfg.text_embed_size
        params["text"] = {
            "embed": {"embedding": normal((cfg.text_vocab_size, e),
                                          np.sqrt(1.0 / e))},
            "lstm": lstm(e, h, bias=True),
            "key_proj": {"kernel": normal((cfg.encoder_dim, cfg.encoder_dim),
                                          np.sqrt(1.0 / cfg.encoder_dim))}}
        head_in *= 2
    params["head_bn"], stats["head_bn"] = bn(head_in)
    params["head"] = {"kernel": normal((head_in, cfg.num_class),
                                       np.sqrt(1.0 / head_in))}
    return params, stats
