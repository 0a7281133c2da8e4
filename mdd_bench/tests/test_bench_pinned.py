"""The yardstick's family-specific arithmetic, pinned: the weights, the
FLOP counts and the reference's first step of both configurations at the
tests' small sizes, against the values that the harness computed on the
CPU before that arithmetic moved into families/cnn_bilstm.py
(pinned.json, pinned_logprobs.npz).  Weights and FLOP counts are equal
bit for bit; the loss and the log-probs to 1e-6 relative, since another
CPU thread count may sum in another order."""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from mdd_bench import corpus, flops, manifest, reference
from mdd_bench.tests import small
from mdd_bench.weights import make_weights

HERE = pathlib.Path(__file__).resolve().parent
PINNED = json.loads((HERE / "pinned.json").read_text())
CONFIGS = ("attention_aug", "cnn_rnn_ctc")
SHAPES = ((1, 48, 20), (256, 256, 64), (3, 7, 1))


def _cfg(name):
    return dict(manifest.config(name), **small.CFG)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", (7, 2 ** 31 + 11))
def test_weights_are_bit_for_bit(name, seed):
    h = hashlib.sha256()
    for k, v in make_weights(_cfg(name), seed, "cpu").items():
        h.update(k.encode())
        h.update(repr(tuple(v.shape)).encode())
        h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == PINNED["weights"][f"{name}/{seed}"]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("size", ("small", "full"))
def test_flops_are_exact(name, size):
    cfg = _cfg(name) if size == "small" else manifest.config(name)
    key = name if size == "small" else name + "/full"
    got = [repr(flops.train_step_flops(cfg, *s)) for s in SHAPES]
    assert got == PINNED["flops"][key]


@pytest.mark.parametrize("name", CONFIGS)
def test_the_references_first_step(name):
    cfg = _cfg(name)
    mix = dict(manifest.traffic("train_b256"), **small.MIX)
    seed = 2 ** 31 + 5
    data = corpus.generate(mix, cfg["units"], seed)
    batches = reference.first_batches(data, cfg, mix, seed, 1)
    ref = reference.run_steps(data, cfg, batches,
                              make_weights(cfg, seed, "cpu"), seed, "cpu")
    assert ref["loss"][0] == pytest.approx(float(PINNED["loss"][name]),
                                           rel=1e-6, abs=0)
    assert ref["input_sizes"][0].tolist() == PINNED["input_sizes"][name]
    with np.load(HERE / "pinned_logprobs.npz") as pinned:
        want = torch.from_numpy(pinned[name])
    torch.testing.assert_close(ref["log_probs"][0], want, rtol=1e-6,
                               atol=0)
