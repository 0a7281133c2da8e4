"""The slot layout of csrc/ctc_loss.cu's `ctc_alpha` on the CPU: one warp a
row, P consecutive slots a lane (s = lane * P + p, P the smallest of the
kernel's instances >= ceil(S / 32); the lanes past slot S - 1 leave), the
slots s - 1 and s - 2 of a lane's first two slots taken from the lane
below by two shuffles, emulated here as shifts of the lane axis (a lane
below the shift's distance keeps its own value, as __shfl_up_sync gives
it), and the last lane's spare slots stored to slot S - 1 before the slot
that owns it.  The emulation takes each slot's arithmetic from the plain
version's `_logsumexp3`, so it must equal
ops/ctc_cuda.ctc_loss_fwd_reference bit for bit (nll, and the alphas of
every frame before a row's input length, frame 0 at input length 0), and
mdd_tpu's `_alpha_scan` within 1e-5 relative.  The card's kernel is held
to the plain version in chip_smoke.py phase kernel-ctc."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdd_tpu.ops.ctc_loss import _alpha_scan, _prep
from mdd_tpu_torch.ops import ctc_cuda

LOG_EPS = ctc_cuda.LOG_EPS
LANES = 32
#: the slots a lane of the kernel's instances (mdd_ctc_alpha's dispatch)
PER_LANE = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


def per_lane(slots: int) -> int:
    return next(p for p in PER_LANE if LANES * p >= slots)


def _shift_up(x, d: int):
    """__shfl_up_sync over the lane axis (dim 1): lane k gets lane k - d's
    value, lanes below d keep their own."""
    return torch.cat([x[:, :d], x[:, :-d]], dim=1)


def warp_alpha(log_probs, input_lengths, labels, label_lengths,
               blank: int = 0):
    """-> (nll (B,), alphas (T, B, S)) the way the kernel's lanes compute
    them; the alphas of a row past its input length are left at the last
    frame's (the kernel writes none there)."""
    t_max, b, c = log_probs.shape
    lens, lab = ctc_cuda._clamped_lengths(t_max, labels.shape[1],
                                          input_lengths, label_lengths)
    s_n = 2 * labels.shape[1] + 1
    p_n = per_lane(s_n)
    slot = torch.arange(LANES * p_n).view(1, LANES, p_n)
    in_s = slot < s_n

    def ext_at(s):
        lab_idx = (s // 2).clamp(0, max(labels.shape[1] - 1, 0))
        if labels.shape[1] == 0:
            return torch.full((b,) + s.shape[1:], blank, dtype=torch.long)
        got = labels.long()[:, lab_idx.flatten()].view((b,) + s.shape[1:])
        return torch.where(s % 2 == 1, got, torch.full_like(got, blank))

    ext = torch.where(in_s, ext_at(slot), torch.full((b, LANES, p_n), blank))
    ext_m2 = torch.where(in_s & (slot >= 2), ext_at((slot - 2).clamp_min(0)),
                         torch.full((b, LANES, p_n), blank))
    can_skip = in_s & (ext != blank) & (ext != ext_m2) & (slot >= 2)
    valid = slot < 2 * lab.view(b, 1, 1) + 1
    cls = torch.where(in_s & (ext >= 0) & (ext < c), ext,
                      torch.full_like(ext, -1))

    def emit(t):
        e = log_probs[t].gather(1, cls.clamp_min(0).view(b, -1)).view(
            b, LANES, p_n)
        return torch.where(cls >= 0, e, torch.zeros_like(e))

    floor = torch.full((b, LANES, p_n), LOG_EPS, dtype=log_probs.dtype)
    first = (slot == 0) | ((slot == 1) & (lab.view(b, 1, 1) > 0))
    a = torch.where(first, emit(0), floor)
    out = [a.reshape(b, -1)[:, :s_n]]
    for t in range(1, t_max):
        up1 = _shift_up(a[:, :, p_n - 1], 1)
        up2 = (_shift_up(a[:, :, p_n - 2], 1) if p_n >= 2
               else _shift_up(a[:, :, 0], 2))
        e = emit(t)
        cols = []
        for p in range(p_n):
            s = slot[:, :, p]
            x0 = a[:, :, p]
            x1 = a[:, :, p - 1] if p >= 1 else torch.where(
                s >= 1, up1, torch.full_like(up1, LOG_EPS))
            x2 = a[:, :, p - 2] if p >= 2 else (up1 if p == 1 else up2)
            x2 = torch.where(can_skip[:, :, p], x2,
                             torch.full_like(x2, LOG_EPS))
            v = ctc_cuda._logsumexp3(x0, x1, x2) + e[:, :, p]
            cols.append(torch.where(valid[:, :, p], v,
                                    torch.full_like(v, LOG_EPS)))
        new = torch.stack(cols, dim=2)
        a = torch.where((t < lens).view(b, 1, 1), new, a)
        out.append(a.reshape(b, -1)[:, :s_n])
    # nll from the lanes that hold slots 2l and 2l - 1
    flat = a.reshape(b, -1)
    end = 2 * lab
    last = flat.gather(1, end[:, None])[:, 0]
    second = flat.gather(1, (end - 1).clamp_min(0)[:, None])[:, 0]
    second = torch.where(end >= 1, second, torch.full_like(second, LOG_EPS))
    m = torch.maximum(last, second)
    ll = m + torch.log(torch.exp(last - m) + torch.exp(second - m))
    ll = torch.where(m <= LOG_EPS / 2, torch.full_like(ll, LOG_EPS), ll)
    return -ll, torch.stack(out)


#: (name, T, B, L, C, case); S = 2L + 1 gives P
CASES = [("P=1 (S=31)", 40, 5, 15, 7, "random"),
         ("P=3 (S=81)", 110, 4, 40, 43, "random"),
         ("P=32 (S=1023)", 1100, 2, 511, 43, "random"),
         ("P=1, input lengths 0 and 1", 24, 6, 15, 7, "short"),
         ("P=3, input lengths 0 and 1", 60, 6, 40, 43, "short"),
         ("P=1, label length 0", 24, 4, 15, 7, "no-labels"),
         ("P=3, label length 0", 60, 4, 40, 43, "no-labels"),
         ("P=1, labels repeated back to back", 40, 4, 15, 7, "repeats"),
         ("P=3, labels repeated back to back", 110, 4, 40, 43, "repeats")]


def _inputs(t, b, l, c, case, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, b, c)).astype(np.float32) * 2
    lp = np.asarray(torch.log_softmax(torch.from_numpy(logits), -1))
    labels = rng.integers(1, c, (b, l)).astype(np.int64)
    label_lengths = rng.integers(l // 2, l + 1, b).astype(np.int64)
    input_lengths = rng.integers(t // 2, t + 1, b).astype(np.int64)
    input_lengths[0] = t
    if case == "short":
        input_lengths[:4] = [0, 0, 1, 1]
        label_lengths[:4] = [0, 1, 0, 1]
    if case == "no-labels":
        label_lengths[: b // 2] = 0
    if case == "repeats":
        labels[:, 1::2] = labels[:, 0::2][:, :l // 2]
    return lp, input_lengths, labels, label_lengths


@pytest.mark.parametrize("name,t,b,l,c,case", CASES)
def test_warp_layout_equals_the_plain_version_and_mdd_tpu(name, t, b, l, c,
                                                          case):
    arrays = _inputs(t, b, l, c, case, CASES.index((name, t, b, l, c,
                                                    case)))
    args = [torch.from_numpy(a) for a in arrays]
    assert per_lane(2 * l + 1) == int(name.split("P=")[1].split()[0]
                                      .strip(",()"))
    nll, alphas = warp_alpha(*args)
    ref_nll, ref_alphas = ctc_cuda.ctc_loss_fwd_reference(*args)
    lens = args[1].clamp(0, t)
    assert torch.equal(nll, ref_nll)
    for row in range(b):
        n = max(int(lens[row]), 1)
        assert torch.equal(alphas[:n, row], ref_alphas[:n, row]), row
    lp, il, labels, ll = arrays
    prep = _prep(jnp.asarray(lp), jnp.asarray(labels), jnp.asarray(ll), 0)
    want_alphas, want_nll = _alpha_scan(jnp.asarray(lp), jnp.asarray(il),
                                        jnp.asarray(ll), *prep)
    np.testing.assert_allclose(nll.numpy(), np.asarray(want_nll), rtol=1e-5)
    want_alphas = np.asarray(want_alphas)
    for row in range(b):
        n = max(int(lens[row]), 1)
        np.testing.assert_allclose(alphas[:n, row].numpy(),
                                   want_alphas[:n, row], rtol=1e-5)


def test_the_lane_shifts_are_shuffles_up():
    """A lane below the shift's distance keeps its own value; every other
    lane reads the lane d below."""
    x = torch.arange(2 * LANES, dtype=torch.float32).view(2, LANES)
    for d in (1, 2):
        got = _shift_up(x, d)
        assert torch.equal(got[:, :d], x[:, :d])
        assert torch.equal(got[:, d:], x[:, :-d])


@pytest.mark.parametrize("slots", [1, 31, 81, 100, 1023])
def test_the_last_lanes_spare_slots_store_before_slot_s_minus_1(slots):
    """A frame's stores as the kernel makes them: each lane that holds a
    slot stores its P values from p = P - 1 down to 0, a slot past S - 1
    to S - 1; what lands is every slot's own value."""
    p_n = per_lane(slots)
    values = torch.arange(LANES * p_n, dtype=torch.float32) + 0.5
    row = torch.full((slots,), float("nan"))
    for lane in range(-(-slots // p_n)):
        for p in reversed(range(p_n)):
            s = lane * p_n + p
            row[min(s, slots - 1)] = values[s]
    assert torch.equal(row, values[:slots])
