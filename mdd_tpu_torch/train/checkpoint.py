"""The port's checkpoints (counterpart of mdd_tpu/train/checkpoint.py), in
its own format or in mdd_tpu's.

A checkpoint `<directory>/<name>` in the port's format ("torch") is
`<name>.pt`, the model's state_dict written by `torch.save`, and
`<name>.meta.json`, the same metadata mdd_tpu bundles (its `model_config`
rebuilds the model); a resumable one (the trainer's `latest`) adds
`<name>.opt.pt`, the optimizer's state_dict.  In mdd_tpu's format
("orbax") it is the orbax directory `<name>/` beside `<name>.meta.json`
(train/orbax_format.py), and a resumable one holds optax's Adam state,
mapped to and from torch's by convert.optax_adam_to_torch /
torch_adam_to_optax.  Where both exist, the port's `.pt` is read.

A resumable checkpoint of the port, in either format, adds
`<name>.snap.pt`, the plateau machine's two snapshots (the restore point
of every halving and the best-acc state that becomes `best`), each a
(model state, optimizer state) pair or None, with the epoch they were
written at.  mdd_tpu neither writes nor reads that file: a `latest` of
its own has none (a resume there restores nothing until the dev loss
improves again), and one it writes leaves the port's file of an older
epoch behind.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch


def _to_cpu(obj):
    """A copy of a (nested) state dict with every tensor on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(directory: str, name: str,
                    state_dict: Dict[str, torch.Tensor],
                    meta: Dict[str, Any],
                    optimizer_state: Optional[Dict[str, Any]] = None,
                    snapshots: Optional[Dict[str, Any]] = None,
                    kind: str = "torch",
                    model: Optional[torch.nn.Module] = None) -> str:
    """Write the checkpoint `name` in the format `kind`: "torch"
    (`<name>.pt`, and given an optimizer state `<name>.opt.pt`) or "orbax"
    (mdd_tpu's `<name>/`, with the optimizer state as optax's, which needs
    `model` for the parameters' names); given the plateau snapshots (a
    dict with their `epoch`) `<name>.snap.pt`; and `<name>.meta.json`.
    Returns the path prefix.

    Each file is written under a temporary name and renamed into place (the
    orbax directory swapped in as mdd_tpu swaps it), so an interrupted save
    never leaves a truncated file behind.  The renames go one file after
    another with the meta last: a save killed half way leaves at worst a
    meta older than its files, never a new meta beside old weights; the
    snapshots carry their epoch, which a restore holds against the meta's."""
    if kind not in ("torch", "orbax"):
        raise ValueError(f"checkpoint format {kind!r} (torch or orbax)")
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, name))
    tmp = f"{path}.tmp-{os.getpid()}"
    suffixes = []
    if kind == "torch":
        torch.save(_to_cpu(dict(state_dict)), tmp + ".pt")
        suffixes.append(".pt")
        if optimizer_state is not None:
            torch.save(_to_cpu(optimizer_state), tmp + ".opt.pt")
            suffixes.append(".opt.pt")
    if snapshots is not None:
        torch.save(_to_cpu(snapshots), tmp + ".snap.pt")
        suffixes.append(".snap.pt")
    if kind == "orbax":
        from mdd_tpu_torch.train.orbax_format import save_mdd_tpu_checkpoint

        for suffix in suffixes:
            os.replace(tmp + suffix, path + suffix)
        save_mdd_tpu_checkpoint(directory, name, _to_cpu(dict(state_dict)),
                                meta, _to_cpu(optimizer_state), model)
        return path
    with open(tmp + ".meta.json", "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2, default=str)
    suffixes.append(".meta.json")
    for suffix in suffixes:
        os.replace(tmp + suffix, path + suffix)
    return path


def checkpoint_format(directory: str, name: str) -> Optional[str]:
    """"torch" where `<name>.pt` exists, "orbax" where `<name>/` is an
    orbax directory (it holds `_METADATA` or `manifest.ocdbt`), else None."""
    path = os.path.abspath(os.path.join(directory, name))
    if os.path.exists(path + ".pt"):
        return "torch"
    if any(os.path.exists(os.path.join(path, f))
           for f in ("_METADATA", "manifest.ocdbt")):
        return "orbax"
    return None


def load_checkpoint(directory: str, name: str
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """-> (state_dict on the CPU, meta dict) of the port's checkpoint or,
    where there is none, of mdd_tpu's orbax checkpoint of that name."""
    path = os.path.abspath(os.path.join(directory, name))
    kind = checkpoint_format(directory, name)
    if kind == "orbax":
        from mdd_tpu_torch.train.orbax_format import load_mdd_tpu_checkpoint

        return load_mdd_tpu_checkpoint(directory, name)
    if kind is None:
        raise FileNotFoundError(
            f"no checkpoint {path}: neither the port's {path}.pt nor "
            f"mdd_tpu's orbax directory {path}/ (with _METADATA)")
    state = torch.load(path + ".pt", map_location="cpu", weights_only=True)
    with open(path + ".meta.json", "r", encoding="utf-8") as f:
        meta = json.load(f)
    return state, meta


def load_optimizer_state(directory: str, name: str,
                         model: Optional[torch.nn.Module] = None,
                         weight_decay: Optional[float] = None
                         ) -> Dict[str, Any]:
    """The torch.optim.Adam state_dict of a resumable checkpoint, on the
    CPU: the port's `<name>.opt.pt`, or the `opt_state` of mdd_tpu's
    orbax `<name>/` mapped by convert.optax_adam_to_torch, which needs
    `model` (the parameters' names, in the optimizer's order) and the
    coupled weight decay (optax's state does not hold it)."""
    path = os.path.abspath(os.path.join(directory, name))
    if checkpoint_format(directory, name) != "orbax":
        return torch.load(path + ".opt.pt", map_location="cpu",
                          weights_only=True)
    from mdd_tpu_torch.convert import optax_adam_to_torch
    from mdd_tpu_torch.train.orbax_format import read_orbax_checkpoint

    if model is None or weight_decay is None:
        raise ValueError(f"mapping {path}/'s optax state to torch's needs "
                         "the model and the weight decay")
    tree = read_orbax_checkpoint(path, only=("opt_state",))
    if "opt_state" not in tree:
        raise ValueError(f"{path}/ holds no opt_state: not a resumable "
                         "checkpoint of mdd_tpu")
    return optax_adam_to_torch(tree["opt_state"], model, weight_decay)


def load_snapshots(directory: str, name: str) -> Optional[Dict[str, Any]]:
    """The plateau snapshots of a resumable checkpoint, on the CPU:
    {"epoch": int, "snapshot": pair or None, "best_acc_state": pair or
    None} (no "epoch" in a file written before it was kept); None for a
    checkpoint written without them."""
    path = os.path.abspath(os.path.join(directory, name)) + ".snap.pt"
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)
