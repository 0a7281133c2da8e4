"""The port's checkpoint format (counterpart of mdd_tpu/train/checkpoint.py).

A checkpoint `<directory>/<name>` is `<name>.pt`, the model's state_dict
written by `torch.save`, and `<name>.meta.json`, the same metadata mdd_tpu
bundles (its `model_config` rebuilds the model); a resumable one (the
trainer's `latest`) adds `<name>.opt.pt`, the optimizer's state_dict, and
`<name>.snap.pt`, the plateau machine's two snapshots (the restore point of
every halving and the best-acc state that becomes `best`), each a (model
state, optimizer state) pair or None.  mdd_tpu's `latest` has no snapshot
file: a resume there restores nothing until the dev loss improves again.
`load_checkpoint` also reads mdd_tpu's own checkpoint, the orbax directory
`<name>/` beside `<name>.meta.json` (train/orbax_format.py); the optimizer
state and the snapshots are read from the port's files only.
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
                    snapshots: Optional[Dict[str, Any]] = None) -> str:
    """Write `<name>.pt`, `<name>.meta.json` and, given an optimizer state,
    `<name>.opt.pt`, given the plateau snapshots, `<name>.snap.pt`;
    returns the path prefix.

    Each file is written under a temporary name and renamed into place, so
    an interrupted save never leaves a truncated file behind.  The renames
    go one file after another with the meta last: a save killed half way
    leaves at worst a meta older than its files, never a new meta beside
    old weights or old snapshots."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, name))
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(_to_cpu(dict(state_dict)), tmp + ".pt")
    suffixes = [".pt"]
    if optimizer_state is not None:
        torch.save(_to_cpu(optimizer_state), tmp + ".opt.pt")
        suffixes.append(".opt.pt")
    if snapshots is not None:
        torch.save(_to_cpu(snapshots), tmp + ".snap.pt")
        suffixes.append(".snap.pt")
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


def load_optimizer_state(directory: str, name: str) -> Dict[str, Any]:
    """The optimizer state_dict of a resumable checkpoint, on the CPU."""
    path = os.path.abspath(os.path.join(directory, name))
    return torch.load(path + ".opt.pt", map_location="cpu",
                      weights_only=True)


def load_snapshots(directory: str, name: str) -> Optional[Dict[str, Any]]:
    """The plateau snapshots of a resumable checkpoint, on the CPU:
    {"snapshot": pair or None, "best_acc_state": pair or None}; None for
    a checkpoint written without them."""
    path = os.path.abspath(os.path.join(directory, name)) + ".snap.pt"
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)
