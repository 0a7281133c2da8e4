"""Activation / posterior visualizer (counterpart of
mdd_tpu/utils/visualize.py).

For one utterance: a heatmap PNG of the input features, of the first six
3-D intermediate activations and a line plot of the framewise phone
posteriors, drawn with matplotlib's Agg backend.  A Python API, no CLI
command, as in mdd_tpu:

    from mdd_tpu_torch.utils.visualize import visualize_utterance
    paths = visualize_utterance(model, feats, trans_ids, id2word, "out/")

`model` is the CTCAttentionModel with its weights; it runs on its own
device (the card, unless the caller put it on the CPU), in eval mode
under torch.no_grad().  mdd_tpu captures the activations with flax's
`capture_intermediates`; here forward hooks record each module's output
under its flax path (`rnn1/bn/__call__`, ...), in the order flax's
collection lists them, and are removed when the forward ends.  Two flax
modules have no called counterpart in the port: the dropout after each
BiLSTM is a function here (its eval-mode output is the layer's output),
and the text embedding is a parameter lookup (its entry is the lookup
before the padding mask, computed when the text encoder starts).
`capture_activations` runs the capture alone and needs no matplotlib;
the plotting functions import it inside `_plt()` and raise an
ImportError that names it where it is missing.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from mdd_tpu_torch.models.ctc_model import BiLstmLayer, TextEncoder


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("mdd_tpu_torch.utils.visualize draws with "
                          "matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_heatmap(mat: np.ndarray, title: str, out_path: str) -> str:
    """(T, D) matrix -> heatmap PNG (features, activations)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(np.asarray(mat).T, aspect="auto", origin="lower",
                   interpolation="nearest", cmap="viridis")
    ax.set_xlabel("frame")
    ax.set_ylabel("dim")
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


def plot_posteriors(log_probs: np.ndarray, id2word: Dict[int, str],
                    out_path: str, top_k: int = 8,
                    title: str = "phone posteriors") -> str:
    """(T, C) log-probs -> line plot of the most active classes
    (reference visualize.py:121-133 framewise prob lines)."""
    plt = _plt()
    probs = np.exp(np.asarray(log_probs))
    top = np.argsort(probs.max(axis=0))[::-1][:top_k]
    fig, ax = plt.subplots(figsize=(10, 4))
    for c in top:
        ax.plot(probs[:, c], label=id2word.get(int(c), str(c)))
    ax.set_xlabel("frame")
    ax.set_ylabel("P(phone)")
    ax.set_title(title)
    ax.legend(ncol=4, fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


def _call(path: str) -> str:
    return f"{path}/__call__" if path else "__call__"


def capture_activations(model, feats: np.ndarray, trans_ids: np.ndarray,
                        limit: int = 6
                        ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """One eval-mode forward of `model` on (T, D) spliced features and
    (L,) canonical phone ids -> ((T', 1, C) log-probs, the first `limit`
    3-D activations by flax path), float32 on the host."""
    device = next(model.parameters()).device
    events: List[Tuple[str, object]] = []
    handles = []

    def after(path, drop):
        def hook(module, args, out):
            if drop:      # flax's `drop` submodule: the layer's output
                events.append((_call(f"{path}/drop"), out))
            events.append((_call(path), out))
        return hook

    def embed(path):
        def hook(module, args):
            trans, _, dtype = args
            lookup = module.embed.embedding.to(dtype)[trans]
            events.append((_call(f"{path}/embed"), lookup))
        return hook

    was_training = model.training
    try:
        for name, module in model.named_modules():
            path = name.replace(".", "/")
            if isinstance(module, TextEncoder):
                handles.append(module.register_forward_pre_hook(embed(path)))
            handles.append(module.register_forward_hook(
                after(path, isinstance(module, BiLstmLayer))))
        model.eval()
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(feats, np.float32),
                                device=device)[None]
            ids = torch.as_tensor(np.asarray(trans_ids),
                                  device=device).long()[None]
            lengths = torch.tensor([ids.shape[1]], device=device)
            log_probs = model(x, ids, lengths)
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    flat = _flatten_intermediates(events, limit)
    host = lambda t: t.detach().float().cpu().numpy()
    return host(log_probs), {k: host(v) for k, v in flat.items()}


def visualize_utterance(
    model,
    feats: np.ndarray,          # (T, D) spliced features
    trans_ids: np.ndarray,      # (L,) canonical phone ids
    id2word: Dict[int, str],
    out_dir: str,
    prefix: str = "utt",
) -> List[str]:
    """Render input / conv / rnn / posterior plots for one utterance."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = [plot_heatmap(feats, "input features",
                          str(out / f"{prefix}_input.png"))]
    log_probs, flat = capture_activations(model, feats, trans_ids)
    for name, a in flat.items():
        if a.ndim == 3 and a.shape[0] == 1:     # (1, T, D)
            paths.append(plot_heatmap(
                a[0], name,
                str(out / f"{prefix}_{name.replace('/', '_')}.png")))
    paths.append(plot_posteriors(
        log_probs[:, 0, :], id2word, str(out / f"{prefix}_posteriors.png")))
    return paths


def _flatten_intermediates(events: Sequence[Tuple[str, object]],
                           limit: int = 6) -> Dict:
    """The first `limit` 3-D arrays of (flax path, module output) events
    in call order, as mdd_tpu's walk of the intermediates tree gives them:
    a tuple output counts element by element, and a path seen again keeps
    its place and takes the later array."""
    flat: Dict[str, torch.Tensor] = {}
    for name, out in events:
        for arr in (out if isinstance(out, tuple) else (out,)):
            if len(flat) >= limit:
                return flat
            if isinstance(arr, torch.Tensor) and arr.dim() == 3:
                flat[name] = arr
    return flat
