"""The faults a training cell can have, planted under the timed path, for
the runs that show the comparison catches them (tests/test_bench_faults.py
on the CPU; `python3 -m mdd_bench.control --fault NAME` at the cell's size
on the card):

* `state_unchanged`: Adam's step returns and leaves the parameters and
  its state as they were;
* `half_batch`: the loss is the mean over the first half of the batch's
  rows, the rest left out;
* `answer_altered`: the step's WER error count is one more than computed;
* `token_altered`: one feature of the gathered batch is changed where the
  device-resident corpus produces it;
* `exchange_left_out`: the ranks' gradients are not summed (several ranks
  only).
"""

from __future__ import annotations

import contextlib

import torch

NAMES = ("state_unchanged", "half_batch", "answer_altered", "token_altered",
         "exchange_left_out")


def _half_batch(inner):
    def ctc_loss(log_probs, sizes, targets, tsizes):
        nll = inner(log_probs, sizes, targets, tsizes)
        keep = torch.arange(nll.shape[0], device=nll.device) \
            < nll.shape[0] // 2
        return torch.where(keep, 2 * nll, torch.zeros_like(nll))
    return ctc_loss


def _answer_altered(inner):
    def greedy_wer(*args):
        errs, tokens = inner(*args)
        return errs + 1, tokens
    return greedy_wer


def _token_altered(inner):
    def gather(self, batch):
        inputs, fracs = inner(self, batch)
        inputs = inputs.clone()
        inputs[0, 0, 0] += 1.0
        return inputs, fracs
    return gather


@contextlib.contextmanager
def planted(name: str):
    """The program with the fault `name` for the block."""
    from mdd_tpu_torch.data.device_cache import DeviceFeatureCache
    from mdd_tpu_torch.train import loop

    owner, attr, make = {
        "state_unchanged": (torch.optim.Adam, "step",
                            lambda inner: lambda self, closure=None: None),
        "half_batch": (loop, "ctc_loss", _half_batch),
        "answer_altered": (loop, "greedy_wer", _answer_altered),
        "token_altered": (DeviceFeatureCache, "gather", _token_altered),
        "exchange_left_out": (loop.Trainer, "all_reduce_gradients",
                              lambda inner: lambda self: None),
    }[name]
    inner = getattr(owner, attr)
    setattr(owner, attr, make(inner))
    try:
        yield
    finally:
        setattr(owner, attr, inner)
