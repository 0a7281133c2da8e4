"""The port's fused dropout on the CPU, where the wrapper runs the kernel's
plain version: its Philox against an independent numpy uint64
implementation and Random123's known-answer vectors (bit for bit), the
dropout contract tests/test_fused_dropout.py holds mdd_tpu to (keep share,
1/keep scale, rate 0 and 1, one mask for forward and backward), mdd_tpu's
own CPU route beside it (a bernoulli draw, so the two are compared in law,
not bit for bit), and a train step of the port with `use_fused_dropout`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdd_tpu.ops.dropout_pallas import fused_dropout as jax_fused_dropout
from mdd_tpu_torch.data.dataset import Batch
from mdd_tpu_torch.models.ctc_model import ModelConfig
from mdd_tpu_torch.ops import dropout_cuda
from mdd_tpu_torch.ops.dropout_cuda import (
    dropout_bits,
    fused_dropout,
    fused_dropout_apply,
    fused_dropout_reference,
    keep_threshold,
    philox4x32_10,
)
from mdd_tpu_torch.train.loop import Trainer

M32 = np.uint64(0xFFFFFFFF)


def np_philox4x32_10(counter, key):
    """Philox-4x32-10 in numpy uint64, straight from the paper: ten rounds
    of two 32x32 -> 64-bit multiplies, the key bumped between rounds."""
    c = [np.asarray(v, np.uint64) for v in counter]
    k = [np.asarray(v, np.uint64) for v in key]
    sh = np.uint64(32)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> sh) ^ c[1] ^ k[0], p1 & M32,
             (p0 >> sh) ^ c[3] ^ k[1], p0 & M32]
        k = [(k[0] + np.uint64(0x9E3779B9)) & M32,
             (k[1] + np.uint64(0xBB67AE85)) & M32]
    return c


def _t(values):
    return torch.tensor(np.asarray(values, np.int64))


# Random123's kat_vectors for philox4x32 with 10 rounds: counter, key, out
KNOWN_ANSWERS = [
    ([0, 0, 0, 0], [0, 0],
     [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
    ([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2,
     [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
    ([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344],
     [0xA4093822, 0x299F31D0],
     [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
]


@pytest.mark.parametrize("counter,key,want", KNOWN_ANSWERS,
                         ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    """The int64-tensor Philox and the numpy uint64 one both give the
    published vectors."""
    got = philox4x32_10([_t([v]) for v in counter], [_t(v) for v in key])
    assert [int(v) for v in got] == want
    assert [int(v) for v in np_philox4x32_10(counter, key)] == want


def test_philox_equals_numpy_on_random_words():
    """Every word of counter and key random over the full 32 bits (so the
    high counter word and the products' top bits are exercised)."""
    rng = np.random.default_rng(0)
    counter = [rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
               for _ in range(4)]
    key = [rng.integers(0, 2 ** 32, dtype=np.uint64) for _ in range(2)]
    got = philox4x32_10([_t(c) for c in counter], [_t(k) for k in key])
    want = np_philox4x32_10(counter, key)
    for g, w in zip(got, want):
        assert g.min() >= 0
        np.testing.assert_array_equal(g.numpy().astype(np.uint64), w)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023])
def test_dropout_bits_follow_the_flat_index(n):
    """Element i takes word i & 3 of the block with counter (i >> 2, 0, 0,
    0) and key (lo32(seed), hi32(seed))."""
    seed = 0x1234_5678_9ABC_DEF0 >> 1
    bits = dropout_bits(torch.tensor([seed]), n).numpy()
    groups = np.arange(-(-n // 4), dtype=np.uint64)
    zero = np.zeros_like(groups)
    words = np_philox4x32_10(
        [groups, zero, zero, zero],
        [np.uint64(seed & 0xFFFFFFFF), np.uint64(seed >> 32)])
    want = np.stack(words, axis=1).reshape(-1)[:n]
    np.testing.assert_array_equal(bits.astype(np.uint64), want)


def test_keep_threshold():
    assert keep_threshold(0.5) == 2 ** 31
    assert keep_threshold(0.2) == round(0.8 * 2 ** 32)
    assert keep_threshold(1e-12) == 2 ** 32 - 1


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_keep_share_and_scale(rate):
    """Kept share within 4 sigma of keep; kept values are x / keep."""
    x = torch.ones((64, 256))
    y = fused_dropout_reference(x, torch.tensor([11]), rate)
    n, keep = x.numel(), 1.0 - rate
    kept = (y != 0).float().mean().item()
    assert abs(kept - keep) < 4 * (keep * rate / n) ** 0.5
    np.testing.assert_allclose(y[y != 0].numpy(), 1.0 / keep, rtol=1e-6)


def test_same_law_as_the_jax_cpu_route():
    """mdd_tpu's fused_dropout off the TPU is a bernoulli draw: its masks
    differ from ours bit by bit and agree in law.  Both zero-shares lie
    within 0.02 of the rate (the tolerance of tests/test_fused_dropout.py)
    and both scale the kept values by 1 / keep."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 256)).astype(np.float32) + 3.0
    ref = np.asarray(jax_fused_dropout(jnp.asarray(x), jax.random.key(0),
                                       0.2))
    ours = fused_dropout(torch.from_numpy(x), 0.2,
                         torch.Generator().manual_seed(0)).numpy()
    for y in (ref, ours):
        assert abs((y == 0).mean() - 0.2) < 0.02
        np.testing.assert_allclose(y[y != 0], (x / 0.8)[y != 0], rtol=1e-6)


def test_rate_zero_and_one():
    x = torch.arange(12.0).reshape(3, 4)
    g = torch.Generator().manual_seed(0)
    assert fused_dropout(x, 0.0, g) is x
    assert torch.equal(fused_dropout(x, 1.0, g), torch.zeros_like(x))
    with pytest.raises(ValueError, match="rate"):
        fused_dropout_reference(x, torch.tensor([1]), 1.0)
    with pytest.raises(ValueError, match="seed"):
        fused_dropout_reference(x, torch.tensor([1, 2]), 0.5)


def test_forward_and_backward_share_one_mask():
    """The gradient is mask / keep * dy with the forward's mask, also for
    a cotangent that arrives as a transposed view; only the seed and the
    rate are saved."""
    x = (torch.randn((32, 128), generator=torch.Generator().manual_seed(2))
         + 5.0).requires_grad_()
    dy = torch.randn((128, 32), generator=torch.Generator().manual_seed(3)).t()
    y = fused_dropout(x, 0.3, torch.Generator().manual_seed(4))
    assert [tuple(t.shape) for t in y.grad_fn.saved_tensors] == [(1,)]
    y.backward(dy)
    mask = y != 0
    scale = torch.tensor(1.0 / 0.7, dtype=torch.float32)
    assert torch.equal(x.grad, torch.where(mask, dy * scale, 0.0))
    assert 0.6 < mask.float().mean() < 0.8


def test_one_seed_per_call():
    """Sites and steps draw their own seeds: two calls on one generator
    give different masks, the same generator state the same mask."""
    x = torch.ones(4096)
    g = torch.Generator().manual_seed(5)
    a, b = fused_dropout(x, 0.5, g), fused_dropout(x, 0.5, g)
    assert not torch.equal(a, b)
    assert torch.equal(a, fused_dropout(x, 0.5,
                                        torch.Generator().manual_seed(5)))


def test_bfloat16_product_runs_in_float32():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(6)
                    ).to(torch.bfloat16)
    seed = torch.tensor([9])
    y = fused_dropout_reference(x, seed, 0.1)
    assert y.dtype == torch.bfloat16
    keep = dropout_bits(seed, 1000) < keep_threshold(0.1)
    want = (x.float() * torch.tensor(1 / 0.9, dtype=torch.float32)
            ).to(torch.bfloat16)
    assert torch.equal(y[keep], want[keep]) and not y[~keep].any()


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    before = dropout_cuda.fused_dropout_kernel.launches
    x = torch.randn(10)
    seed = torch.tensor([3])
    assert torch.equal(fused_dropout_apply(x, seed, 0.5),
                       fused_dropout_reference(x, seed, 0.5))
    assert dropout_cuda.fused_dropout_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        dropout_cuda.fused_dropout_kernel(x, seed, 0.5)


SMALL = dict(input_dim=243, num_class=12, conv_channels=(4, 4),
             rnn_hidden_size=16, rnn_layers=2, text_embed_size=8,
             text_vocab_size=14, use_pallas_lstm=True)


def _batch(seed=0, b=4, t=24, l=6):
    rng = np.random.default_rng(seed)
    trans = rng.integers(2, 12, (b, l)).astype(np.int32)
    sizes = np.asarray([6, 4, 3, 5], np.int32)
    return Batch(inputs=rng.standard_normal((b, t, 243)).astype(np.float32),
                 input_fracs=np.asarray([1.0, 0.8, 0.6, 1.0], np.float32),
                 targets=trans.copy(), target_sizes=sizes.copy(),
                 trans=trans, trans_sizes=sizes,
                 utt_ids=[f"u{i}" for i in range(b)])


def _step(cfg, calls=None):
    trainer = Trainer(cfg, device="cpu", seed=7)
    if calls is not None:
        real = dropout_cuda.FusedDropout.apply
        dropout_cuda.FusedDropout.apply = staticmethod(
            lambda *a: calls.append(a[0].shape) or real(*a))
    try:
        acc = trainer.train_step(trainer.batch_arrays(_batch()),
                                 torch.zeros(4))
    finally:
        if calls is not None:
            dropout_cuda.FusedDropout.apply = real
    return acc, trainer


def test_train_step_with_fused_dropout():
    """A port train step with `use_fused_dropout` goes through the fused
    op at its 4 sites here (2 convolutions + 2 BiLSTM layers; 6 at the
    flagship's 4 layers), the BiLSTM sites on the time-major tensor, and
    gives a finite loss and finite gradients; at dropout 0 its loss equals
    the plain path's exactly (no site draws anything)."""
    calls = []
    cfg = ModelConfig(**SMALL, dropout=0.2, use_fused_dropout=True)
    acc, trainer = _step(cfg, calls)
    assert [len(s) for s in calls] == [4, 4, 3, 3]
    assert calls[2] == (12, 4, 32)              # (T', B, 2H): time-major
    assert torch.isfinite(acc).all() and acc[3] == 1
    assert all(torch.isfinite(p.grad).all()
               for p in trainer.model.parameters())
    zero = dataclasses.replace(cfg, dropout=0.0)
    acc_fused, _ = _step(zero)
    acc_plain, _ = _step(dataclasses.replace(zero, use_fused_dropout=False))
    assert torch.equal(acc_fused, acc_plain)
