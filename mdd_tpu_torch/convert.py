"""Weight bridge: flax parameter trees <-> the port's state_dict, and
optax's Adam state <-> torch.optim.Adam's.

mdd_tpu checkpoints hold two nested dicts, `params` and `batch_stats`,
laid out by flax module path (`rnn0/w_ih_fwd`, `conv/bn0/mean`, ...).
The port's modules carry the same paths as their names, so the bridge is
a renaming ('/' -> '.') plus one layout change: convolution kernels go
from flax HWIO to torch OIHW.  Every leaf must map and none may be left
over.  The numpy arrays come from the port's own reader of mdd_tpu's
orbax files (train/orbax_format.py, which needs no JAX or orbax), or
from orbax itself in a process that has it.  `torch_to_flax` is the
inverse, for the port's writer of those files.

A resumable mdd_tpu checkpoint adds `opt_state`, the state of mdd_tpu's
`make_optimizer`: optax.inject_hyperparams over chain(add_decayed_weights,
scale_by_adam, scale).  `optax_adam_to_torch` and `torch_adam_to_optax`
map it to and from a torch.optim.Adam state_dict; Adam's two moments take
the weights' layout map.

`random_flax_variables` makes seeded weights in the same flax layout, so
a full-width model can be run without a trained checkpoint.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Tuple

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


def _check_leaves(flat_p: Dict[str, Any], flat_s: Dict[str, Any],
                  direction: str) -> None:
    """Raise ValueError unless the flat params and batch_stats are exactly
    the leaves of one CTCAttentionModel (their counts read from the keys)."""
    n_conv = _count((k.split("/")[1] for k in flat_p
                     if k.startswith("conv/")), r"conv(\d+)")
    n_rnn = _count((k.split("/")[0] for k in flat_p), r"rnn(\d+)")
    text = any(k.startswith("text/") for k in flat_p)
    want_p, want_s = _expected_leaves(n_conv, n_rnn, text)
    problems = []
    for what, have, want in (("params", flat_p, want_p),
                             ("batch_stats", flat_s, want_s)):
        if missing := sorted(want - have.keys()):
            problems.append(f"{what} missing {missing}")
        if unknown := sorted(have.keys() - want):
            problems.append(f"{what} has unknown leaves {unknown}")
    if problems:
        raise ValueError(f"{direction} bridge: " + "; ".join(problems))


def _is_conv_kernel(path: str) -> bool:
    return re.fullmatch(r"conv/conv\d+/kernel", path) is not None


def _leaf_to_torch(path: str, value) -> torch.Tensor:
    """One flax leaf at `path` ('/'-separated) in the port's layout."""
    value = np.asarray(value)
    if _is_conv_kernel(path):
        value = value.transpose(3, 2, 0, 1)                  # HWIO -> OIHW
    # a copy: the caller's arrays may be read-only views
    return torch.from_numpy(np.array(value, dtype=np.float32, order="C"))


def _leaf_to_flax(path: str, tensor: torch.Tensor) -> np.ndarray:
    """The inverse of _leaf_to_torch: a float32 numpy copy in flax's
    layout."""
    value = tensor.detach().to("cpu", torch.float32).numpy()
    if _is_conv_kernel(path):
        value = value.transpose(2, 3, 1, 0)                  # OIHW -> HWIO
    return np.array(value, dtype=np.float32, order="C")


def _unflatten(flat: Dict[str, Any]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def flax_to_torch(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """Nested numpy dicts laid out as an mdd_tpu checkpoint -> state_dict
    for CTCAttentionModel.  Raises ValueError on a missing or unknown leaf."""
    flat_p, flat_s = _flatten(params), _flatten(batch_stats)
    _check_leaves(flat_p, flat_s, "flax -> torch")
    return {path.replace("/", "."): _leaf_to_torch(path, value)
            for path, value in list(flat_p.items()) + list(flat_s.items())}


def torch_to_flax(state_dict: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    """The inverse of flax_to_torch: a CTCAttentionModel state_dict ->
    (params, batch_stats), nested dicts of float32 numpy arrays on the
    host.  Raises ValueError on a missing or unknown leaf."""
    flat = {k.replace(".", "/"): v for k, v in state_dict.items()}
    flat_s = {k: v for k, v in flat.items()
              if k.rsplit("/", 1)[-1] in ("mean", "var")}
    flat_p = {k: v for k, v in flat.items() if k not in flat_s}
    _check_leaves(flat_p, flat_s, "torch -> flax")
    return tuple(_unflatten({k: _leaf_to_flax(k, v) for k, v in part.items()})
                 for part in (flat_p, flat_s))


# ------------------------------------------------------------ Adam state

# optax.scale_by_adam's defaults, which mdd_tpu's make_optimizer keeps;
# torch.optim.Adam's are the same (b1, b2, eps; optax's eps_root is 0)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _adam_state_of(opt_state: dict) -> dict:
    """The scale_by_adam state inside mdd_tpu's optimizer tree, after
    checking the tree around it; raises ValueError naming what differs."""
    if not isinstance(opt_state, dict):
        raise ValueError(f"optax Adam state: a {type(opt_state).__name__}, "
                         "not the tree of inject_hyperparams")
    keys = {"count", "hyperparams", "hyperparams_states", "inner_state"}
    if set(opt_state) != keys:
        raise ValueError(f"optax Adam state: fields {sorted(opt_state)}, "
                         f"expected {sorted(keys)}")
    hyper = opt_state["hyperparams"]
    if not isinstance(hyper, dict) or set(hyper) != {"learning_rate"}:
        raise ValueError(f"optax Adam state: hyperparams {hyper!r}, "
                         "expected {'learning_rate'} only")
    if opt_state["hyperparams_states"] not in ({}, None):
        raise ValueError(f"optax Adam state: hyperparams_states "
                         f"{opt_state['hyperparams_states']!r} is not empty")
    inner = opt_state["inner_state"]
    adam = inner[1] if isinstance(inner, (list, tuple)) and len(inner) == 3 \
        else None
    if (adam is None or inner[0] is not None or inner[2] is not None
            or not isinstance(adam, dict)
            or set(adam) != {"count", "mu", "nu"}):
        raise ValueError(f"optax Adam state: inner_state is not [None, "
                         f"{{count, mu, nu}}, None] (add_decayed_weights, "
                         f"scale_by_adam, scale): {_describe(inner)}")
    inject, count = (int(np.asarray(c))
                     for c in (opt_state["count"], adam["count"]))
    if inject != count:
        raise ValueError(f"optax Adam state: inject_hyperparams count "
                         f"{inject} != scale_by_adam count {count}")
    return adam


def _describe(node) -> str:
    """A tree's structure with its arrays as their shapes, for messages."""
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k}: {_describe(v)}"
                               for k, v in node.items()) + "}"
    if isinstance(node, (list, tuple)):
        return "[" + ", ".join(_describe(v) for v in node) + "]"
    if node is None:
        return "None"
    return f"array{tuple(np.shape(node))}"


def optax_adam_to_torch(opt_state: dict, model: torch.nn.Module,
                        weight_decay: float) -> Dict[str, Any]:
    """mdd_tpu's optimizer state -> a torch.optim.Adam state_dict for
    `model`'s parameters, in `model.parameters()` order (the order the
    port's Trainer builds its optimizer in).

    `opt_state` is the tree read_orbax_checkpoint gives for
    `opt_state`: {count: int32, hyperparams: {learning_rate: f32},
    hyperparams_states: {}, inner_state: [None, {count, mu, nu}, None]}.
    Each parameter's `exp_avg` / `exp_avg_sq` are `mu` / `nu` in the
    weights' layout, its `step` is Adam's count as a float32 CPU tensor
    (where torch keeps it), and the group's `lr` is the stored learning
    rate.  Adam's b1, b2 and eps are optax's defaults (0.9, 0.999, 1e-8,
    eps_root 0), which are torch's.  The coupled weight decay is not in
    optax's state (add_decayed_weights holds it in the chain, from
    mdd_tpu's config), so the caller gives its own.  A tree that does not
    map raises ValueError: no moment is made up or dropped."""
    adam = _adam_state_of(opt_state)
    flat_mu, flat_nu = _flatten(adam["mu"]), _flatten(adam["nu"])
    names = [n.replace(".", "/") for n, _ in model.named_parameters()]
    problems = []
    for what, flat in (("mu", flat_mu), ("nu", flat_nu)):
        if missing := sorted(set(names) - flat.keys()):
            problems.append(f"parameters without their {what}: {missing}")
        if unknown := sorted(flat.keys() - set(names)):
            problems.append(f"{what} of no parameter: {unknown}")
    if problems:
        raise ValueError("optax Adam state: " + "; ".join(problems))
    lr = float(np.asarray(opt_state["hyperparams"]["learning_rate"]))
    step = float(int(np.asarray(adam["count"])))
    groups = torch.optim.Adam(model.parameters(), lr=lr,
                              weight_decay=weight_decay,
                              betas=(ADAM_B1, ADAM_B2),
                              eps=ADAM_EPS).state_dict()["param_groups"]
    state = {}
    for i, ((name, p), path) in enumerate(zip(model.named_parameters(),
                                              names)):
        moments = [_leaf_to_torch(path, flat[path])
                   for flat in (flat_mu, flat_nu)]
        for what, m in zip(("mu", "nu"), moments):
            if m.shape != p.shape:
                raise ValueError(
                    f"optax Adam state: {what} of {path} has shape "
                    f"{tuple(m.shape)} in the port's layout, the parameter "
                    f"{tuple(p.shape)}")
        state[i] = {"step": torch.tensor(step, dtype=torch.float32),
                    "exp_avg": moments[0], "exp_avg_sq": moments[1]}
    return {"state": state, "param_groups": groups}


def torch_adam_to_optax(optimizer, model: torch.nn.Module) -> dict:
    """The inverse of optax_adam_to_torch: a torch.optim.Adam (or its
    state_dict, such as a snapshot's CPU copy) over `model.parameters()`
    -> the tree of mdd_tpu's optimizer state, numpy on the host, both
    counts int32 and the learning rate a 0-d float32.  Only the names
    are read from `model`.  An optimizer that optax's tree cannot hold
    (another b1, b2 or eps, amsgrad, maximize, several groups, a parameter
    without moments, unequal steps) raises ValueError."""
    sd = (optimizer.state_dict() if isinstance(optimizer,
                                               torch.optim.Optimizer)
          else optimizer)
    if len(sd["param_groups"]) != 1:
        raise ValueError(f"torch Adam state: {len(sd['param_groups'])} "
                         "param groups, optax's tree holds one")
    group = sd["param_groups"][0]
    fixed = {"betas": (ADAM_B1, ADAM_B2), "eps": ADAM_EPS, "amsgrad": False,
             "maximize": False, "decoupled_weight_decay": False}
    for key, want in fixed.items():
        got = group.get(key, want)
        if (tuple(got) if key == "betas" else got) != want:
            raise ValueError(f"torch Adam state: {key} {got!r}, "
                             f"optax's Adam has {want!r}")
    names = [n.replace(".", "/") for n, _ in model.named_parameters()]
    if list(group["params"]) != list(range(len(names))):
        raise ValueError(f"torch Adam state: the group's params "
                         f"{group['params']} are not the model's "
                         f"{len(names)} parameters in order")
    state = sd["state"]
    if missing := [n for i, n in enumerate(names) if i not in state]:
        raise ValueError(f"torch Adam state: parameters without their "
                         f"moments: {missing}")
    steps = {float(state[i]["step"]) for i in range(len(names))}
    if len(steps) != 1:
        raise ValueError(f"torch Adam state: the parameters' steps differ: "
                         f"{sorted(steps)}")
    mu = {path: _leaf_to_flax(path, state[i]["exp_avg"])
          for i, path in enumerate(names)}
    nu = {path: _leaf_to_flax(path, state[i]["exp_avg_sq"])
          for i, path in enumerate(names)}
    count = np.asarray(int(steps.pop()), np.int32)
    return {"count": count,
            "hyperparams": {"learning_rate": np.asarray(group["lr"],
                                                        np.float32)},
            "hyperparams_states": {},
            "inner_state": [None, {"count": count.copy(),
                                   "mu": _unflatten(mu),
                                   "nu": _unflatten(nu)}, None]}


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
