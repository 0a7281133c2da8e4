"""The comparison that decides `correct`: what the program produced in its
first steps against what the reference works out for them.

Numbers, each held to its cell's limit (limits/<cell>.json):

* `batch_mismatch`: elements of the first steps' batches (the gathered and
  masked raw features, the length fractions, labels, transcripts, sizes and
  the row mask) that differ from the reference's; exact, limit 0.
* `wer_count_gap`: over those steps, |errors - errors'| + |tokens -
  tokens'| of the program's WER counts against the greedy decode of the
  program's own log-probs worked out by the reference; exact, limit 0.
* `logprob_gap`: the widest gap between the program's and the reference's
  first-step log-probs, over the real frames of the real rows.
* `loss_gap`: the relative gap between the first step's loss and the
  reference's.  The later steps' gaps are not compared: Adam's first step
  moves every element by about its learning rate whatever the gradient's
  size, so the elements whose tiny gradients differ in sign between the
  bfloat16 program and the float32 reference move apart, and the later
  losses part by up to ~50 times the first step's gap (PERF.md).
* `grad_gap`: of the first gradient as Adam took it (its first moment
  after one step, over 1 - beta1), the worst leaf's gap between the two
  norms, over the larger of the reference leaf's norm and the median
  leaf's.
* `update_gap`: the same of each parameter's change over the steps.

Leaves whose reference gradient norm is under a thousandth of the median
leaf's (the convolution biases, which BatchNorm cancels) move by rounding
alone and are left out of the last two.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from mdd_bench import ranks
from mdd_bench.reference import greedy_wer

ZERO_GRAD = 1e-3        # of the median leaf's gradient norm


def gather_program(cap, world: int) -> dict:
    """The capture, with each step's loss summed over the ranks (each
    holds its rows' share); everything else is this rank's."""
    losses = ranks.all_sum([float(v) for v in cap.loss])
    rows = cap.arrays[0][0].shape[0]
    return {"arrays": cap.arrays, "log_probs": cap.log_probs,
            "loss": losses, "errs": [int(e) for e in cap.errs],
            "tokens": [int(t) for t in cap.tokens], "grad1": cap.grad1,
            "params": cap.params, "rows": slice(0, rows)}


def _mismatch(a: torch.Tensor, b: torch.Tensor) -> float:
    if tuple(a.shape) != tuple(b.shape):
        return float("inf")
    return float((a != b).sum())


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: List[str]) -> Dict[str, float]:
    """Each leaf's | |prog| - |ref| | over max(|ref|, median |ref|)."""
    ref_n = {k: float(ref[k].double().norm()) for k in keep}
    median = float(np.median(list(ref_n.values())))
    return {k: abs(float(prog[k].double().norm()) - ref_n[k])
            / max(ref_n[k], median, 1e-30) for k in keep}


def judge(prog: dict, ref: dict, batches, w0: Dict[str, torch.Tensor],
          limits: Dict[str, float], rows: slice,
          detail: Optional[dict] = None) -> Dict[str, dict]:
    """-> {number: {"value", "limit"}}; `detail`, where given, receives
    each step's two losses and the worst leaves of the last two numbers."""
    n = len(batches)
    mism = 0.0
    wer_gap = 0
    for step in range(n):
        b = batches[step]
        got = prog["arrays"][step] if step < len(prog["arrays"]) else None
        if got is None:
            mism = float("inf")
            break
        inputs, fracs, targets, tsizes, trans, trsizes, valid = got
        lengths = torch.as_tensor(b.lengths[rows])
        want = (ref["inputs"][step][rows],
                lengths.float() / b.bucket,
                torch.as_tensor(b.targets[rows]),
                torch.as_tensor(b.target_sizes[rows]),
                torch.as_tensor(b.trans[rows]),
                torch.as_tensor(b.trans_sizes[rows]),
                torch.as_tensor(b.valid[rows]))
        for g, w in zip(got, want):
            mism += _mismatch(g.cpu().to(w.dtype), w)
        if step < len(prog["log_probs"]):
            errs, tokens = greedy_wer(
                prog["log_probs"][step].float(),
                ref["input_sizes"][step][rows], b.targets[rows],
                b.target_sizes[rows], b.valid[rows])
            wer_gap += (abs(prog["errs"][step] - errs)
                        + abs(prog["tokens"][step] - tokens))
        else:
            wer_gap = float("inf")
    # the first step's log-probs over the real frames of the real rows
    lp_gap = float("inf")
    if prog["log_probs"]:
        lp, lr = prog["log_probs"][0].float(), ref["log_probs"][0][:, rows]
        if lp.shape == lr.shape:
            t = torch.arange(lp.shape[0])[:, None]
            sizes = ref["input_sizes"][0][rows]
            real = (t < sizes[None]) & torch.as_tensor(
                batches[0].valid[rows])[None]
            diff = (lp - lr).abs()[real]
            lp_gap = float(diff.max()) if diff.numel() else float("inf")
    loss_gap = float("inf")
    if prog["loss"]:
        loss_gap = abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])
    g_ref = ref["grad1"]
    norms = {k: float(v.double().norm()) for k, v in g_ref.items()}
    floor = ZERO_GRAD * float(np.median(list(norms.values())))
    keep = [k for k in g_ref if norms[k] >= floor]
    grad_gap = update_gap = float("inf")
    if prog["grad1"] and prog["params"]:
        grads = leaf_gaps(prog["grad1"], g_ref, keep)
        delta = {k: prog["params"][k].float() - w0[k].float() for k in keep}
        updates = leaf_gaps(delta, ref["delta"], keep)
        grad_gap, update_gap = max(grads.values()), max(updates.values())
        if detail is not None:
            detail["grad_leaves"] = sorted(grads.items(),
                                           key=lambda kv: -kv[1])[:4]
            detail["update_leaves"] = sorted(updates.items(),
                                             key=lambda kv: -kv[1])[:4]
            detail["loss"] = [[prog["loss"][s], ref["loss"][s]]
                              for s in range(min(n, len(prog["loss"])))]
    numbers = {"batch_mismatch": mism, "wer_count_gap": float(wer_gap),
               "logprob_gap": lp_gap, "loss_gap": loss_gap,
               "grad_gap": grad_gap, "update_gap": update_gap}
    return {k: {"value": v, "limit": float(limits[k])}
            for k, v in numbers.items()}
