"""The CUDA kernels on the card (the LSTM recurrences under both
contracts, the fused dropout, the train WER, the beam and the CTC loss):
against their plain versions, the refusals of the wrappers, and autograd
through the backward kernels; and the bfloat16 BiLSTMs' input projections
on cuBLAS's tensor cores against the float32 products they replaced.
Marked `cuda`; skips where there is no card.
No JAX here, so the file runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math
import sys
import threading

import numpy as np
import pytest
import torch

from mdd_tpu_torch.ops import dropout_cuda, lstm_cuda
from mdd_tpu_torch.ops.lstm import bilstm, input_projections
from mdd_tpu_torch.utils.precision import strict_float32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    strict_float32("cuda", "float32")
    return torch.device("cuda")


def _inputs(t, b, h, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x_proj = torch.randn((t, 2, b, 4 * h), generator=g) * 0.5
    w_hh = (torch.rand((2, h, 4 * h), generator=g) * 2 - 1) / h ** 0.5
    return x_proj.to("cuda", dtype), w_hh.to("cuda", dtype)


# the partition over (direction, 16-row batch tile, group of 8 units):
# batches under a tile, between tiles, over several tiles a launch and over
# several launches (256, 512 at H=384), no recurrent step and one, H a
# multiple of 8 but not of 64, and an H whose K-slices take a warp two
# rounds of loads (512)
PARTITION_SHAPES = [(16, 1, 384), (80, 16, 384), (80, 64, 384),
                    (128, 64, 384), (16, 256, 384), (1, 3, 8), (5, 37, 64),
                    (80, 4, 384), (16, 24, 384), (1, 24, 384), (2, 4, 384),
                    (2, 24, 40), (1, 4, 24), (7, 17, 72), (1, 1, 8),
                    (16, 4, 384), (4, 512, 384), (8, 20, 512)]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,b,h", PARTITION_SHAPES)
def test_kernel_matches_plain_version(cuda, dtype, atol, t, b, h):
    """hs and cs; float32 differs from the plain version only in the order
    of the recurrent dot's sums and its three TF32 passes (~2^-20 of a
    product), bfloat16 by 1-ulp roundings of h."""
    x_proj, w_hh = _inputs(t, b, h, dtype)
    before = lstm_cuda.lstm_fwd_kernel.launches
    hs, cs = lstm_cuda.lstm_seq_fwd(x_proj, w_hh)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_fwd_kernel.launches == before + 1
    ref_hs, ref_cs = lstm_cuda.lstm_seq_fwd_reference(x_proj, w_hh)
    assert hs.dtype == cs.dtype == dtype
    torch.testing.assert_close(hs.float(), ref_hs.float(), atol=atol, rtol=0)
    torch.testing.assert_close(cs.float(), ref_cs.float(), atol=atol, rtol=0)


def test_forward_kernel_is_the_same_from_run_to_run(cuda):
    """Every sum inside runs in a fixed order (no atomics on data)."""
    for b in (4, 24, 64):
        x_proj, w_hh = _inputs(40, b, 384, torch.float32)
        first = lstm_cuda.lstm_seq_fwd(x_proj, w_hh)
        again = lstm_cuda.lstm_seq_fwd(x_proj, w_hh)
        assert torch.equal(first[0], again[0])
        assert torch.equal(first[1], again[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_plan_keeps_every_block_resident(cuda, dtype):
    """The recurrence is a cooperative launch: a launch's blocks, one a
    (direction, 16-row tile, unit group), fit the card's SMs at the shared
    memory each takes, and a batch too large for one launch runs as
    several of whole tiles."""
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    smem_sm = getattr(props, "shared_memory_per_multiprocessor", 233472)
    for b in (1, 4, 16, 24, 64, 256, 512):
        plan = lstm_cuda.lstm_fwd_kernel.plan(b, 384, dtype)
        per_sm = smem_sm // (plan["smem_bytes"] + 1024)
        assert 0 < plan["blocks"] <= sms * per_sm
        tiles = -(-min(b, plan["chunk_rows"]) // 16)
        assert plan["blocks"] == 2 * tiles * (384 // (8 * plan["unit_groups"]))
        assert plan["launches"] == -(-b // plan["chunk_rows"])
        assert plan["split_w"] in (0, 1)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x_proj, w_hh = _inputs(4, 2, 12, torch.float32)
    with pytest.raises(ValueError, match="H % 8"):
        lstm_cuda.lstm_fwd_kernel(x_proj, w_hh)
    x_proj, w_hh = _inputs(4, 2, 16, torch.float16)
    with pytest.raises(TypeError):
        lstm_cuda.lstm_fwd_kernel(x_proj, w_hh)
    x_proj, w_hh = _inputs(4, 2, 16, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cuda.lstm_fwd_kernel(torch.cat([x_proj, x_proj], -1)[..., ::2],
                                  w_hh)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,b,h", [(16, 1, 384), (80, 16, 384),
                                   (80, 64, 384), (128, 64, 384),
                                   (16, 256, 384), (1, 3, 8), (5, 37, 64),
                                   (80, 4, 384), (16, 24, 384), (1, 24, 384),
                                   (2, 4, 384), (2, 24, 40), (1, 4, 24),
                                   (7, 17, 72)])
def test_backward_kernel_matches_plain_version(cuda, dtype, tol, t, b, h):
    """dx_proj and dW_hh, each relative to its largest magnitude: float32
    sums run in another order and its products are three TF32 passes,
    bfloat16 rounds dgates (1-ulp flips).  The shapes cover the partition
    over (direction, 16-row batch tile, group of 8 units): batches under a
    tile, between tiles and over the most tiles one launch holds, no
    recurrent step and one, H a multiple of 8 but not of 64."""
    x_proj, w_hh = _inputs(t, b, h, dtype)
    g = torch.Generator().manual_seed(1)
    dhs = torch.randn((t, 2, b, h), generator=g).cuda()
    hs, cs = lstm_cuda.lstm_seq_fwd_reference(x_proj, w_hh)
    before = lstm_cuda.lstm_bwd_kernel.launches
    dxp, dw = lstm_cuda.lstm_seq_bwd(x_proj, w_hh, hs, cs, dhs)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_bwd_kernel.launches == before + 1
    ref_dxp, ref_dw = lstm_cuda.lstm_seq_bwd_reference(x_proj, w_hh, hs, cs,
                                                       dhs)
    assert dxp.dtype == dtype and dw.dtype == torch.float32
    for got, want in ((dxp.float(), ref_dxp.float()), (dw, ref_dw)):
        assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("kernel", ["lstm_fwd", "lstm_bwd", "lstm_scan_fwd",
                                    "lstm_scan_bwd"])
def test_kernels_keep_their_counters_from_a_staging_thread(cuda, kernel):
    """A thread that puts small host arrays on the card while the kernel
    is launched over and over (evaluate's staging thread) changes none of
    the kernel's bits, and the kernel writes nothing into that thread's
    tensors: the barrier counters stay the launch's own until it is
    enqueued."""
    t, b = 16, 1
    x_proj, w_hh = _inputs(t, b, 384, torch.float32)
    if kernel == "lstm_fwd":
        def run():
            return lstm_cuda.lstm_fwd_kernel(x_proj, w_hh)
    elif kernel == "lstm_scan_fwd":
        x_proj, w_hh = x_proj.bfloat16(), w_hh.bfloat16()

        def run():
            return lstm_cuda.lstm_scan_fwd_kernel(x_proj, w_hh)
    elif kernel == "lstm_scan_bwd":
        x_proj, w_hh = x_proj.bfloat16(), w_hh.bfloat16()
        dhs = torch.randn((t, 2, b, 384), device="cuda").bfloat16().float()
        hs, cs = lstm_cuda.lstm_scan_fwd(x_proj, w_hh)

        def run():
            return lstm_cuda.lstm_scan_bwd_kernel(x_proj, w_hh, hs, cs, dhs)
    else:
        dhs = torch.randn((t, 2, b, 384), device="cuda")
        hs, cs = lstm_cuda.lstm_seq_fwd(x_proj, w_hh)

        def run():
            return lstm_cuda.lstm_bwd_kernel(x_proj, w_hh, hs, cs, dhs)
    first = run()
    # the counters' size at B = 1, so that the thread's tensors take the
    # blocks a wrapper frees
    host = np.arange(2 * 32, dtype=np.int32)
    stop, staged = threading.Event(), []

    def stage():
        while not stop.is_set():
            staged.append(torch.as_tensor(host).to("cuda", non_blocking=True))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)      # switch threads between any two lines
    thread = threading.Thread(target=stage)
    thread.start()
    try:
        outs = [run() for _ in range(200)]
    finally:
        stop.set()
        thread.join()
        sys.setswitchinterval(interval)
    assert all(torch.equal(o[0], first[0]) and torch.equal(o[1], first[1])
               for o in outs)
    assert staged
    assert torch.equal(torch.stack(staged),
                       torch.as_tensor(host, device="cuda").expand(
                           len(staged), -1))


def test_backward_kernel_is_the_same_from_run_to_run(cuda):
    """Every sum inside runs in a fixed order (no atomics on data)."""
    x_proj, w_hh = _inputs(40, 24, 384, torch.float32)
    dhs = torch.randn((40, 2, 24, 384), device="cuda")
    hs, cs = lstm_cuda.lstm_seq_fwd(x_proj, w_hh)
    first = lstm_cuda.lstm_seq_bwd(x_proj, w_hh, hs, cs, dhs)
    again = lstm_cuda.lstm_seq_bwd(x_proj, w_hh, hs, cs, dhs)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b", [512, 300])
def test_backward_wrapper_refuses_a_batch_whose_blocks_cannot_be_resident(
        cuda, dtype, tol, b):
    """The name dates from when the recurrence was one cooperative launch
    and refused a batch whose blocks could not all be resident (B > 256 at
    H=384 in float32).  Now such a batch runs as several launches over
    chunks of its rows, like the forward's: B=512 and B=300 (a ragged last
    chunk) agree with the plain version (tolerances as in
    test_backward_kernel_matches_plain_version), give the same bits on two
    runs, count one launch a backward, and every launch's blocks fit the
    card."""
    t, h = 6, 384
    x_proj, w_hh = _inputs(t, b, h, dtype)
    dhs = torch.randn((t, 2, b, h), generator=torch.Generator().manual_seed(1)
                      ).cuda()
    hs, cs = lstm_cuda.lstm_seq_fwd_reference(x_proj, w_hh)
    before = lstm_cuda.lstm_bwd_kernel.launches
    first = lstm_cuda.lstm_seq_bwd(x_proj, w_hh, hs, cs, dhs)
    again = lstm_cuda.lstm_seq_bwd(x_proj, w_hh, hs, cs, dhs)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_bwd_kernel.launches == before + 2
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    ref_dxp, ref_dw = lstm_cuda.lstm_seq_bwd_reference(x_proj, w_hh, hs, cs,
                                                       dhs)
    for got, want in ((first[0].float(), ref_dxp.float()), (first[1], ref_dw)):
        assert (got - want).abs().max() <= tol * want.abs().max()
    plan = lstm_cuda.lstm_bwd_kernel.plan(t, b, h, dtype)
    props = torch.cuda.get_device_properties(0)
    smem_sm = getattr(props, "shared_memory_per_multiprocessor", 233472)
    per_sm = smem_sm // (plan["smem_bytes"] + 1024)
    assert 0 < plan["blocks"] <= props.multi_processor_count * per_sm
    chunk_tiles = -(-plan["chunk_rows"] // 16)
    assert plan["blocks"] == 2 * chunk_tiles * (h // (8 * plan["unit_groups"]))
    assert plan["launches"] == -(-b // plan["chunk_rows"])
    # a block owns one 16-row tile, and no H100 holds the blocks of 300 rows
    # (2 x 19 tiles x H / 8 G unit groups) at the shared memory each takes
    assert plan["launches"] > 1


def test_launch_through_a_device_without_an_index(cuda):
    """torch.device("cuda") names the current device: the binding launches
    there (the mma.sync-rate yardstick passes such a device)."""
    from mdd_tpu_torch.ops.mma_rate import CASES, MmaRate

    rate = MmaRate()
    _, mode, ops = CASES[0]
    tflops = rate.tflops(mode, ops, 1, 1)
    assert rate.launches == 1 and 0 < tflops < 1e4


def test_loss_backward_through_bilstm_cuda_launches_the_kernel(cuda):
    """Autograd through the facade: one backward launch per call, and the
    gradients agree with autograd through the plain loop."""
    g = torch.Generator().manual_seed(2)
    t, b, d_in, h = 12, 5, 24, 32
    s = h ** -0.5
    x = torch.randn((t, b, d_in), generator=g)
    ws = [(torch.rand(shape, generator=g) * 2 - 1) * s
          for shape in ((d_in, 4 * h), (h, 4 * h)) * 2]
    grads = []
    for fn in (lstm_cuda.bilstm_cuda, bilstm):
        args = [a.cuda().requires_grad_() for a in [x] + ws]
        fn(*args).square().sum().backward()
        grads.append([a.grad for a in args])
    before = lstm_cuda.lstm_bwd_kernel.launches
    args = [a.cuda().requires_grad_() for a in [x] + ws]
    lstm_cuda.bilstm_cuda(*args).sum().backward()
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_bwd_kernel.launches == before + 1
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1,), (3,), (4,), (1023,), (7, 129),
                                   (16, 110, 768), (8, 32, 220, 122)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_kernel_equals_plain_version_bit_for_bit(cuda, dtype, shape,
                                                         rate):
    """Same Philox, same float32 product, same rounding: no tolerance."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(shape, generator=g).to("cuda", dtype)
    seed = torch.tensor([0x1234_5678_9ABC_DEF0 >> 1], device="cuda")
    before = dropout_cuda.fused_dropout_kernel.launches
    out = dropout_cuda.fused_dropout_apply(x, seed, rate)
    torch.cuda.synchronize()
    assert dropout_cuda.fused_dropout_kernel.launches == before + 1
    ref = dropout_cuda.fused_dropout_reference(x, seed, rate)
    assert out.dtype == dtype and out.shape == x.shape
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(out.view(bits), ref.view(bits))


def test_dropout_kernel_on_unaligned_storage(cuda):
    """A contiguous slice that starts 4 bytes into an allocation takes the
    scalar path and the same mask."""
    x = torch.randn(4099, device="cuda")
    seed = torch.tensor([77], device="cuda")
    out = dropout_cuda.fused_dropout_apply(x[1:], seed, 0.2)
    assert torch.equal(out, dropout_cuda.fused_dropout_reference(
        x[1:].clone(), seed, 0.2))
    assert torch.equal(out, dropout_cuda.fused_dropout_apply(
        x[1:].clone(), seed, 0.2))


# element counts at the edges of the kernel's geometry: a 16-byte access is
# 4 float32 or 8 bfloat16 elements and a thread has 4 of them in flight, so
# sizes around one access (3-9, 15-17), around one thread's span (31-33),
# around a block's span of 256 threads (4095-4097, 8191-8193), and past one
# wave of resident threads walking the tensor (9,000,001: more than 132 SMs
# x 2048 threads x 32 bfloat16 elements)
EDGE_SIZES = [1, 3, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 4095, 4096, 4097,
              8191, 8192, 8193, 9_000_001]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", EDGE_SIZES)
def test_dropout_kernel_at_the_edges_of_its_geometry(cuda, dtype, n):
    """Bit for bit the plain version at every edge of the geometry."""
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, generator=g).to("cuda", dtype)
    seed = torch.tensor([0x0123_4567_89AB_CDEF], device="cuda")
    out = dropout_cuda.fused_dropout_apply(x, seed, 0.3)
    ref = dropout_cuda.fused_dropout_reference(x, seed, 0.3)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(out.view(bits), ref.view(bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 2, 3, 4, 8])
def test_dropout_kernel_on_storage_that_breaks_16_byte_alignment(cuda, dtype,
                                                                 offset):
    """A contiguous slice whose first element lies `offset` elements into
    its allocation: 16-byte aligned only at offset 4 in float32 and 8 in
    bfloat16; the others take the scalar path.  The same bits as the plain
    version on the slice, and as the kernel on an aligned copy of it."""
    x = torch.randn(70_000 + offset, device="cuda").to(dtype)
    seed = torch.tensor([99], device="cuda")
    view = x[offset:]
    out = dropout_cuda.fused_dropout_apply(view, seed, 0.2)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(out.view(bits), dropout_cuda.fused_dropout_reference(
        view, seed, 0.2).view(bits))
    assert torch.equal(out.view(bits), dropout_cuda.fused_dropout_apply(
        view.clone(), seed, 0.2).view(bits))


def test_dropout_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.randn(8, 6, device="cuda")
    seed = torch.tensor([1], device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        dropout_cuda.fused_dropout_kernel(x.t(), seed, 0.2)
    with pytest.raises(TypeError):
        dropout_cuda.fused_dropout_kernel(x.half(), seed, 0.2)
    with pytest.raises(ValueError, match="seed"):
        dropout_cuda.fused_dropout_kernel(x, seed.cpu(), 0.2)
    with pytest.raises(ValueError, match="rate"):
        dropout_cuda.fused_dropout_kernel(x, seed, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        dropout_cuda.fused_dropout_kernel(x.cpu(), seed.cpu(), 0.2)


def test_dropout_backward_regenerates_the_forward_mask(cuda):
    """Two launches (forward, backward), gradient = mask / keep * dy, also
    through a transposed cotangent; another seed gives another mask."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = (torch.rand(33, 70, device="cuda") + 0.5).requires_grad_()   # no 0
    dy = torch.randn(70, 33, device="cuda").t()
    before = dropout_cuda.fused_dropout_kernel.launches
    out = dropout_cuda.fused_dropout(x, 0.2, gen)
    out.backward(dy)
    torch.cuda.synchronize()
    assert dropout_cuda.fused_dropout_kernel.launches == before + 2
    mask = out != 0
    want = torch.where(mask, (dy * torch.tensor(1.25, device="cuda")), 0.0)
    assert torch.equal(x.grad, want)
    assert abs(mask.float().mean().item() - 0.8) < 4 * (0.16 / x.numel()) ** 0.5
    other = dropout_cuda.fused_dropout(x, 0.2, gen)
    assert not torch.equal(other != 0, mask)


def test_trainer_in_float32_on_the_card_turns_tf32_off(cuda):
    """train's float32 rule: a Trainer built on the card with
    compute_dtype float32 leaves cuBLAS and cuDNN without TF32, whatever
    the process had set before."""
    from mdd_tpu_torch.models.ctc_model import ModelConfig
    from mdd_tpu_torch.train.loop import Trainer

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        Trainer(ModelConfig(input_dim=24, num_class=8, rnn_hidden_size=8,
                            rnn_layers=1, text_embed_size=8),
                device="cuda")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_orbax_latest_restores_alike_on_the_card_and_the_cpu(cuda, tmp_path):
    """An mdd_tpu-format `latest` (optax's Adam state, written by the
    port's orbax writer after one Adam step) restored by a Trainer on the
    card and by one on the CPU: every weight, BatchNorm statistic and Adam
    tensor has the same bits, `step` stays on the CPU in both."""
    from mdd_tpu_torch.models.ctc_model import ModelConfig
    from mdd_tpu_torch.train.loop import Trainer

    cfg = ModelConfig(input_dim=24, num_class=8, rnn_hidden_size=8,
                      rnn_layers=2, text_embed_size=8, dropout=0.0)
    src = Trainer(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    for p in src.model.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    src.optimizer.step()
    src.checkpoint_kind = "orbax"
    src.save(str(tmp_path), "exp", "latest", epoch=1)
    assert (tmp_path / "exp" / "latest" / "manifest.ocdbt").exists()
    got = {}
    for device in ("cuda", "cpu"):
        t = Trainer(cfg, device=device, seed=5)
        assert t.restore(str(tmp_path), "exp", "latest",
                         log=lambda *_: None) == 1
        assert t.checkpoint_kind == "orbax"
        opt = t.optimizer.state_dict()
        assert all(s["step"].device.type == "cpu" and s["step"].item() == 1
                   for s in opt["state"].values())
        assert all(s["exp_avg"].device.type == device
                   for s in opt["state"].values())
        got[device] = ({k: v.cpu() for k, v in t.model.state_dict().items()},
                       {(i, k): v.cpu() for i, s in opt["state"].items()
                        for k, v in s.items()})
    for a, b in zip(got["cuda"], got["cpu"]):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    want = src.optimizer.state_dict()["state"]
    for (i, k), v in got["cuda"][1].items():
        assert torch.equal(v, want[i][k]), (i, k)


# ------------------------------------- the LSTM kernels' scan contract

#: the scan kernels against their plain versions: each tensor relative to
#: its largest magnitude.  Both take the same float32 steps in the same
#: order but for the sums of the dots (the tensor cores' order against
#: cuBLAS's, and for float32 dgates three exact bfloat16 passes), so a
#: rounding to bfloat16 (2^-8) can flip on the other side and carry on
#: through the later steps and the bfloat16 sum of dW_hh
SCAN_TOL = 2e-2
#: the text BiLSTM's shapes: serving's L and B, train's B=64, benchmark's
#: L=48 at B=512 (one forward launch), a ragged 513 (two) and 1040, past
#: one launch of either recurrence and ragged
SCAN_SHAPES = [(t, b) for t in (1, 7, 48)
               for b in (1, 64, 512, 513)] + [(48, 1040)]


def _scan_inputs(t, b, d=512, h=384, seed=0):
    """bfloat16 (x_proj, w_hh) on the card as the text BiLSTM makes them:
    a (T, B, D) embedding through both directions' input projections."""
    g = torch.Generator().manual_seed(seed)
    s = h ** -0.5
    x = torch.randn((t, b, d), generator=g).to("cuda", torch.bfloat16)
    w_ih = [((torch.rand((d, 4 * h), generator=g) * 2 - 1) * s).to(
        "cuda", torch.bfloat16) for _ in range(2)]
    w_hh = ((torch.rand((2, h, 4 * h), generator=g) * 2 - 1) * s).to(
        "cuda", torch.bfloat16)
    xf, xb = input_projections(x, *w_ih)
    return torch.stack([xf, xb], dim=1).bfloat16(), w_hh


def _close(got, want, tol=SCAN_TOL) -> bool:
    got, want = got.float(), want.float()
    return (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("t,b", SCAN_SHAPES)
def test_scan_kernels_match_plain_versions(cuda, t, b):
    """lstm_scan_fwd (hs, and cs: the unrounded float32 c_t) and
    lstm_scan_bwd (dx_proj, dW_hh, both bfloat16) against their plain
    versions at the text BiLSTM's shapes (D=512, H=384), the backward on
    the plain forward's hs and cs and a bfloat16 cotangent; one count a
    call each."""
    x_proj, w_hh = _scan_inputs(t, b)
    dhs = torch.randn((t, 2, b, 384), generator=torch.Generator(
        ).manual_seed(1)).to("cuda", torch.bfloat16)
    before = [lstm_cuda.lstm_scan_fwd_kernel.launches,
              lstm_cuda.lstm_scan_bwd_kernel.launches]
    hs, cs = lstm_cuda.lstm_scan_fwd(x_proj, w_hh)
    ref_hs, ref_cs = lstm_cuda.lstm_scan_fwd_reference(x_proj, w_hh)
    dxp, dw = lstm_cuda.lstm_scan_bwd(x_proj, w_hh, ref_hs, ref_cs, dhs)
    torch.cuda.synchronize()
    assert [lstm_cuda.lstm_scan_fwd_kernel.launches,
            lstm_cuda.lstm_scan_bwd_kernel.launches] == [n + 1 for n in before]
    assert hs.dtype == torch.bfloat16 and cs.dtype == torch.float32
    assert _close(hs, ref_hs) and _close(cs, ref_cs)
    ref_dxp, ref_dw = lstm_cuda.lstm_scan_bwd_reference(x_proj, w_hh, ref_hs,
                                                        ref_cs, dhs)
    assert dxp.dtype == dw.dtype == torch.bfloat16
    assert _close(dxp, ref_dxp)
    if t > 1:
        assert _close(dw, ref_dw)
    else:                  # no step has an h_{t-1}: dW_hh is exactly 0
        assert not dw.any() and not ref_dw.any()


def test_scan_kernels_are_the_same_from_run_to_run(cuda):
    """Every sum of both runs in a fixed order (no atomics on data), at
    the largest shape: several forward launches and a ragged batch."""
    x_proj, w_hh = _scan_inputs(48, 513)
    dhs = torch.randn((48, 2, 513, 384), device="cuda").bfloat16()
    hs, cs = lstm_cuda.lstm_scan_fwd(x_proj, w_hh)
    again = lstm_cuda.lstm_scan_fwd(x_proj, w_hh)
    assert torch.equal(hs, again[0]) and torch.equal(cs, again[1])
    first = lstm_cuda.lstm_scan_bwd(x_proj, w_hh, hs, cs, dhs)
    again = lstm_cuda.lstm_scan_bwd(x_proj, w_hh, hs, cs, dhs)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def test_scan_forward_runs_the_benchmark_batch_in_one_launch(cuda):
    """The forward's plan at benchmark's 48 x 512 (H=384): every row in
    one cooperative launch of blocks that own several 16-row tiles; a
    batch past the card's residency still runs, as several launches."""
    plan = lstm_cuda.lstm_scan_fwd_kernel.plan(512, 384, torch.bfloat16)
    assert plan["launches"] == 1 and plan["tiles_per_block"] > 1
    assert plan["chunk_rows"] == 512
    big = lstm_cuda.lstm_scan_fwd_kernel.plan(1040, 384, torch.bfloat16)
    assert big["launches"] > 1
    bwd = lstm_cuda.lstm_scan_bwd_kernel.plan(48, 512, 384, torch.bfloat16)
    assert bwd["chunk_rows"] * bwd["launches"] >= 512
    assert bwd["dw_scratch_elems"] == 47 * 2 * 384 * 4 * 384


def test_float32_on_the_card_keeps_the_pallas_contract(cuda):
    """The scan kernels take bfloat16 only and do not fall back: a float32
    CUDA tensor is refused before any launch, and the float32 text BiLSTM
    (bilstm_cuda) launches lstm_fwd / lstm_bwd and no scan kernel."""
    x_proj, w_hh = _inputs(5, 4, 64, torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        lstm_cuda.lstm_scan_fwd(x_proj, w_hh)
    kernels = (lstm_cuda.lstm_fwd_kernel, lstm_cuda.lstm_bwd_kernel,
               lstm_cuda.lstm_scan_fwd_kernel, lstm_cuda.lstm_scan_bwd_kernel)
    before = [k.launches for k in kernels]
    x = torch.randn((5, 4, 16), device="cuda", requires_grad=True)
    ws = [torch.randn(shape, device="cuda") * 0.1
          for shape in ((16, 256), (64, 256)) * 2]
    lstm_cuda.bilstm_cuda(x, *ws).sum().backward()
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(kernels, before)] == [1, 1, 0, 0]


def test_loss_backward_through_bilstm_scan_cuda_launches_the_kernels(cuda):
    """Autograd through the scan facade in bfloat16: one forward and one
    backward launch a call, the output equal to the plain loop's within a
    bfloat16 ulp or two, every gradient (x, W_ih, W_hh, biases) within
    SCAN_TOL of autograd through the plain loop (the same contract)."""
    g = torch.Generator().manual_seed(2)
    t, b, d_in, h = 12, 5, 24, 32
    s = h ** -0.5
    x = torch.randn((t, b, d_in), generator=g)
    ws = [(torch.rand(shape, generator=g) * 2 - 1) * s
          for shape in ((d_in, 4 * h), (h, 4 * h)) * 2]
    biases = [torch.randn(4 * h, generator=g) * 0.5 for _ in range(2)]
    outs, grads = [], []
    before = [lstm_cuda.lstm_scan_fwd_kernel.launches,
              lstm_cuda.lstm_scan_bwd_kernel.launches]
    for fn in (lstm_cuda.bilstm_scan_cuda, bilstm):
        args = [a.to("cuda", torch.bfloat16).requires_grad_()
                for a in [x] + ws + biases]
        y = fn(*args)
        (y.float() * torch.linspace(-1, 1, 2 * h, device="cuda")).sum(
            ).backward()
        outs.append(y.detach())
        grads.append([a.grad for a in args])
    torch.cuda.synchronize()
    assert [lstm_cuda.lstm_scan_fwd_kernel.launches,
            lstm_cuda.lstm_scan_bwd_kernel.launches] == [n + 1 for n in before]
    assert _close(outs[0], outs[1])
    for got, want in zip(*grads):
        assert got.dtype == torch.bfloat16 and _close(got, want)


@pytest.fixture
def second_card(cuda):
    """cuda:1 where the host has two cards; the current device stays 0,
    as in a rank of the local mesh whose tensors lie on another card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    torch.cuda.set_device(0)
    return torch.device("cuda", 1)


@pytest.mark.parametrize("kernel", ["lstm_fwd", "lstm_bwd", "lstm_scan_fwd",
                                    "lstm_scan_bwd"])
def test_lstm_kernels_on_a_second_card(second_card, monkeypatch, kernel):
    """Each LSTM wrapper on cuda:1 with cuda:0 current: the launch goes to
    the tensors' card and stream, its barrier counters are allocated
    there, and the result is the plain version's (the tolerances of
    test_kernel_matches_plain_version and its backward)."""
    made = []
    counters = lstm_cuda._barrier_counters

    def recorded(b, device):
        made.append(counters(b, device))
        return made[-1]
    monkeypatch.setattr(lstm_cuda, "_barrier_counters", recorded)
    x_proj, w_hh = (a.to(second_card) for a in _inputs(80, 64, 384,
                                                       torch.float32))
    if kernel.startswith("lstm_scan"):
        x_proj, w_hh = (a.to(second_card) for a in _scan_inputs(48, 64))
        g = torch.Generator().manual_seed(1)
        dhs = torch.randn((48, 2, 64, 384), generator=g).to(
            second_card, torch.bfloat16)
        hs, cs = lstm_cuda.lstm_scan_fwd_reference(x_proj, w_hh)
        if kernel == "lstm_scan_fwd":
            got = lstm_cuda.lstm_scan_fwd(x_proj, w_hh)
            want = hs, cs
        else:
            got = lstm_cuda.lstm_scan_bwd(x_proj, w_hh, hs, cs, dhs)
            want = lstm_cuda.lstm_scan_bwd_reference(x_proj, w_hh, hs, cs,
                                                     dhs)
        tol = [SCAN_TOL * w.float().abs().max().item() for w in want]
    elif kernel == "lstm_fwd":
        got = lstm_cuda.lstm_seq_fwd(x_proj, w_hh)
        want = lstm_cuda.lstm_seq_fwd_reference(x_proj, w_hh)
        tol = [2e-5, 2e-5]
    else:
        g = torch.Generator().manual_seed(1)
        dhs = torch.randn((80, 2, 64, 384), generator=g).to(second_card)
        hs, cs = lstm_cuda.lstm_seq_fwd_reference(x_proj, w_hh)
        got = lstm_cuda.lstm_seq_bwd(x_proj, w_hh, hs, cs, dhs)
        want = lstm_cuda.lstm_seq_bwd_reference(x_proj, w_hh, hs, cs, dhs)
        tol = [1e-4 * w.abs().max().item() for w in want]
    torch.cuda.synchronize(second_card)
    assert torch.cuda.current_device() == 0
    assert [t.device for t in made] == [second_card]
    for a, w, t in zip(got, want, tol):
        assert a.device == second_card
        assert (a.float() - w.float()).abs().max().item() <= t


def test_dropout_kernel_on_a_second_card(second_card):
    x = torch.randn((16, 110, 768), device=second_card)
    seed = torch.tensor([0x1234_5678], device=second_card)
    before = dropout_cuda.fused_dropout_kernel.launches
    out = dropout_cuda.fused_dropout_apply(x, seed, 0.2)
    torch.cuda.synchronize(second_card)
    assert dropout_cuda.fused_dropout_kernel.launches == before + 1
    assert out.device == second_card and torch.cuda.current_device() == 0
    assert torch.equal(out, dropout_cuda.fused_dropout_reference(x, seed,
                                                                 0.2))


# ------------------------------------------- the train WER and the beam
def _wer_inputs(b, t, l, seed, case="random"):
    """Seeded greedy-WER inputs on the card (chip_smoke.py's recipe): ids
    over 43 classes with blanks and repeats, frames in [1, t], sizes in
    [0, l], a sixth of the rows invalid."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 43, (b, t), generator=g)
    ids[torch.rand((b, t), generator=g) < 0.33] = 0
    repeat = torch.rand((b, t - 1), generator=g) < 0.3
    ids[:, 1:] = torch.where(repeat, ids[:, :-1], ids[:, 1:])
    frames = torch.randint(1, t + 1, (b,), generator=g)
    targets = torch.randint(1, 43, (b, l), generator=g)
    sizes = torch.randint(0, l + 1, (b,), generator=g)
    valid = torch.rand(b, generator=g) > 1 / 6
    if case == "no-frames":
        frames[: b // 2] = 0
    if case == "no-targets":
        sizes[: b // 2] = 0
    if case == "all-blank":
        ids[: b // 2] = 0
    ids = ids.cuda()
    if case == "strided":           # the train step's argmax transposed
        ids = ids.t().contiguous().t()
    return ids, frames.cuda(), targets.cuda(), sizes.cuda(), valid.cuda()


WER_SHAPES = [(64, 110, 40, "random"), (64, 47, 16, "random"),
              (64, 80, 40, "strided"), (512, 80, 40, "random"),
              (16, 60, 24, "no-frames"), (16, 60, 24, "no-targets"),
              (16, 60, 24, "all-blank"), (8, 300, 1023, "random"),
              (3, 20, 0, "random"), (5, 33, 31, "random"),
              (5, 33, 32, "random")]


@pytest.mark.parametrize("b,t,l,case", WER_SHAPES)
def test_wer_kernel_equals_plain_version(cuda, b, t, l, case):
    """Integers only: the counts equal the plain loop's exactly."""
    from mdd_tpu_torch.ops import wer_cuda
    from mdd_tpu_torch.ops.wer import greedy_wer_counts

    args = _wer_inputs(b, t, l, seed=b + t + l, case=case)
    before = wer_cuda.greedy_wer_kernel.launches
    got = wer_cuda.greedy_wer(*args)
    torch.cuda.synchronize()
    assert wer_cuda.greedy_wer_kernel.launches == before + 1
    assert [int(v) for v in got] == [int(v) for v in
                                     greedy_wer_counts(*args)]


def test_wer_kernel_is_the_same_from_run_to_run(cuda):
    from mdd_tpu_torch.ops import wer_cuda

    args = _wer_inputs(64, 110, 40, seed=1)
    first = wer_cuda.greedy_wer_kernel(*args)
    for _ in range(3):
        again = wer_cuda.greedy_wer_kernel(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_wer_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from mdd_tpu_torch.ops import wer_cuda

    ids, frames, targets, sizes, valid = _wer_inputs(4, 20, 8, seed=2)
    kernel = wer_cuda.greedy_wer_kernel
    with pytest.raises(TypeError):
        kernel(ids.int(), frames, targets, sizes, valid)
    with pytest.raises(ValueError, match="1023"):
        kernel(ids, frames, torch.ones((4, 1024), dtype=torch.int64,
                                       device="cuda"), sizes, valid)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(ids, torch.stack([frames, frames], 1)[:, 0], targets, sizes,
               valid)
    with pytest.raises(ValueError, match="lies on"):
        kernel(ids, frames.cpu(), targets, sizes, valid)


def _beam_inputs(b, t, c, seed, lm=False, case="random"):
    """Seeded log-probs (blank-boosted, or one-hot clamped at 1e-38),
    lengths and a dense LM matrix (log of seeded Dirichlet rows times
    0.5, or zeros) on the card; "ties" rounds the log-probs and the LM to
    multiples of 0.5, so that many candidates tie and the index order
    decides."""
    rng = np.random.default_rng(seed)
    if case == "peaky":
        ids = rng.integers(0, c, (b, t))
        ids[rng.random((b, t)) < 0.5] = 0
        probs = np.zeros((b, t, c), np.float32)
        np.put_along_axis(probs, ids[..., None], 1.0, -1)
        lp = np.log(np.maximum(probs, 1e-38))
    else:
        logits = rng.standard_normal((b, t, c)).astype(np.float32)
        logits[:, :, 0] += 1.5
        lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lengths = rng.integers(0, t + 1, b) if case == "ragged" else np.full(b, t)
    matrix = (np.log(rng.dirichlet(np.ones(c + 1), c + 1)) * 0.5 if lm
              else np.zeros((c + 1, c + 1)))
    if case == "ties":
        lp, matrix = np.round(lp * 2) / 2, np.round(matrix * 2) / 2
    return (torch.from_numpy(lp.astype(np.float32)).cuda(),
            torch.from_numpy(lengths.astype(np.int64)).cuda(),
            torch.from_numpy(matrix.astype(np.float32)).cuda())


# (B, T', C, K, LM, case): profile-evaluate's shape with and without the
# LM, benchmark's 512 x 80, ragged lengths, B=1, K=1, K=16, the limits,
# one-hot posteriors
BEAM_SHAPES = [(64, 110, 43, 10, False, "random"),
               (64, 110, 43, 10, True, "random"),
               (512, 80, 43, 10, False, "random"),
               (64, 110, 43, 10, True, "ragged"),
               (1, 110, 43, 10, False, "random"),
               (64, 110, 43, 1, False, "random"),
               (64, 110, 43, 16, True, "random"),
               (16, 80, 64, 16, True, "random"),
               (64, 110, 43, 10, False, "peaky"),
               (8, 24, 5, 10, True, "random")]


@pytest.mark.parametrize("b,t,c,k,lm,case", BEAM_SHAPES)
def test_beam_kernel_matches_plain_version(cuda, b, t, c, k, lm, case):
    """The plain version's float order: at least 99% of the sequences
    identical (all, so far) and a token error under 0.002."""
    from mdd_tpu_torch.align.levenshtein import edit_distance
    from mdd_tpu_torch.decode.beam_jit import beam_search_batch
    from mdd_tpu_torch.ops import beam_cuda

    lp, lengths, matrix = _beam_inputs(b, t, c, seed=b + t + c + k, lm=lm,
                                       case=case)
    before = beam_cuda.ctc_beam_kernel.launches
    pre, lens = beam_cuda.ctc_beam_kernel(lp, lengths, matrix, k, 0, 0.1)
    torch.cuda.synchronize()
    assert beam_cuda.ctc_beam_kernel.launches == before + 1
    ref, ref_lens = beam_search_batch(lp, lengths, matrix, k, 0, 0.1)
    got = [pre[i, :lens[i]].tolist() for i in range(b)]
    want = [ref[i, :ref_lens[i]].tolist() for i in range(b)]
    same = sum(x == y for x, y in zip(got, want))
    assert same >= 0.99 * b
    edits = sum(edit_distance(x, y)[0] for x, y in zip(got, want))
    assert edits <= 0.002 * sum(len(y) for y in want)
    tail = torch.arange(t, device="cuda")[None] >= lens[:, None]
    assert not pre[tail].any()


# (B, T', C, K, LM, case): ties decide the order (with and without the LM);
# K=16 over 2 and 3 classes, so that dead beams fill most slots of the
# first frames; B=512 at K=16 (736 threads a row: more rows than the SMs
# hold at once)
BEAM_EXACT_SHAPES = [(64, 110, 43, 10, False, "ties"),
                     (64, 110, 43, 10, True, "ties"),
                     (32, 24, 2, 16, False, "random"),
                     (32, 24, 3, 16, True, "ragged"),
                     (512, 80, 43, 16, True, "random")]


@pytest.mark.parametrize("b,t,c,k,lm,case", BEAM_EXACT_SHAPES)
def test_beam_kernel_equals_plain_version_bit_for_bit(cuda, b, t, c, k, lm,
                                                      case):
    """Every sequence, length and normalised score of the plain version's,
    bit for bit: the sort keys order the candidates as its stable sort
    does."""
    from mdd_tpu_torch.decode.beam_jit import beam_search_batch
    from mdd_tpu_torch.ops import beam_cuda

    lp, lengths, matrix = _beam_inputs(b, t, c, seed=7 * b + t + c + k,
                                       lm=lm, case=case)
    got = beam_cuda.ctc_beam_kernel(lp, lengths, matrix, k, 0, 0.1,
                                    scores=True)
    want = beam_search_batch(lp, lengths, matrix, k, 0, 0.1,
                             return_scores=True)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("lm,case", [(True, "random"), (False, "ties"),
                                     (True, "ties")])
def test_beam_kernel_is_the_same_from_run_to_run(cuda, lm, case):
    from mdd_tpu_torch.ops import beam_cuda

    lp, lengths, matrix = _beam_inputs(64, 110, 43, seed=3, lm=lm, case=case)
    first = beam_cuda.ctc_beam_kernel(lp, lengths, matrix, 10, 0, 0.1,
                                      scores=True)
    for _ in range(3):
        again = beam_cuda.ctc_beam_kernel(lp, lengths, matrix, 10, 0, 0.1,
                                          scores=True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_beam_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from mdd_tpu_torch.ops import beam_cuda

    lp, lengths, matrix = _beam_inputs(4, 20, 43, seed=4)
    kernel = beam_cuda.ctc_beam_kernel
    with pytest.raises(ValueError, match="beam width"):
        kernel(lp, lengths, matrix, 17, 0, 0.1)
    with pytest.raises(TypeError):
        kernel(lp.double(), lengths, matrix, 10, 0, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(lp.transpose(0, 1), lengths, matrix, 10, 0, 0.1)
    with pytest.raises(ValueError, match="classes"):
        wide, _, wide_lm = _beam_inputs(4, 20, 65, seed=4)
        kernel(wide, lengths, wide_lm, 10, 0, 0.1)
    with pytest.raises(ValueError, match="LM matrix"):
        kernel(lp, lengths, matrix[:42, :42].contiguous(), 10, 0, 0.1)


def test_new_kernels_launch_through_a_device_without_an_index(cuda):
    """torch.device("cuda") names the current device: each binding launches
    there (the wrappers pass their tensors' devices, which carry one)."""
    from mdd_tpu_torch.decode.beam_jit import beam_search_batch
    from mdd_tpu_torch.ops import beam_cuda, wer_cuda
    from mdd_tpu_torch.ops.wer import greedy_wer_counts

    ids, frames, targets, sizes, valid = _wer_inputs(8, 30, 10, seed=5)
    dist = torch.empty(8, dtype=torch.int64, device="cuda")
    counts = torch.zeros(2, dtype=torch.int64, device="cuda")
    wer_cuda.greedy_wer_kernel._launch(
        torch.device("cuda"), ids.data_ptr(), ids.stride(0), ids.stride(1),
        frames.data_ptr(), targets.data_ptr(), targets.stride(0),
        targets.stride(1), sizes.data_ptr(), valid.data_ptr(), 8, 30, 10, 0,
        dist.data_ptr(), counts.data_ptr())
    torch.cuda.synchronize()
    assert counts.tolist() == [int(v) for v in greedy_wer_counts(
        ids, frames, targets, sizes, valid)]

    lp, lengths, matrix = _beam_inputs(4, 30, 43, seed=5)
    pre = torch.empty((4, 30), dtype=torch.int64, device="cuda")
    lens = torch.empty(4, dtype=torch.int64, device="cuda")
    norm = torch.empty(4, dtype=torch.float32, device="cuda")
    back = torch.empty(4 * 30 * 10, dtype=torch.int16, device="cuda")
    beam_cuda.ctc_beam_kernel._launch(
        torch.device("cuda"), lp.data_ptr(), lengths.data_ptr(),
        matrix.data_ptr(), pre.data_ptr(), lens.data_ptr(), norm.data_ptr(),
        back.data_ptr(), 4, 30, 43, 44, 10, 0, 0.1, math.log(0.9))
    torch.cuda.synchronize()
    ref, ref_lens = beam_search_batch(lp, lengths, matrix, 10, 0, 0.1)
    assert torch.equal(lens, ref_lens) and torch.equal(pre, ref)


def test_wer_and_beam_kernels_on_a_second_card(second_card):
    from mdd_tpu_torch.decode.beam_jit import beam_search_batch
    from mdd_tpu_torch.ops import beam_cuda, wer_cuda
    from mdd_tpu_torch.ops.wer import greedy_wer_counts

    args = [a.to(second_card) for a in _wer_inputs(64, 110, 40, seed=6)]
    got = wer_cuda.greedy_wer(*args)
    torch.cuda.synchronize(second_card)
    assert got[0].device == second_card
    assert torch.cuda.current_device() == 0
    assert [int(v) for v in got] == [int(v) for v in
                                     greedy_wer_counts(*args)]
    lp, lengths, matrix = (a.to(second_card) for a in
                           _beam_inputs(64, 110, 43, seed=6, lm=True))
    pre, lens = beam_cuda.ctc_beam_kernel(lp, lengths, matrix, 10, 0, 0.1)
    torch.cuda.synchronize(second_card)
    ref, ref_lens = beam_search_batch(lp, lengths, matrix, 10, 0, 0.1)
    assert pre.device == second_card and torch.cuda.current_device() == 0
    assert torch.equal(lens, ref_lens) and torch.equal(pre, ref)


def test_trainer_and_eval_session_on_the_card_launch_both_kernels(cuda):
    """A Trainer's step launches the WER kernel once; an EvalSession with
    the beam decoder launches the beam kernel once a batch."""
    from mdd_tpu_torch.data.dataset import Batch
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.evals.evaluate import EvalSession
    from mdd_tpu_torch.models.ctc_model import ModelConfig
    from mdd_tpu_torch.ops import beam_cuda, wer_cuda
    from mdd_tpu_torch.train.loop import Trainer

    vocab = Vocab(["sil", "aa", "bb", "cc", "dd", "ee"])
    cfg = ModelConfig(input_dim=24, num_class=vocab.n_words,
                      conv_channels=(4, 4), rnn_hidden_size=16,
                      rnn_layers=2, text_embed_size=8, text_vocab_size=16,
                      dropout=0.0)
    rng = np.random.default_rng(7)
    b, t, l = 4, 40, 6
    batch = Batch(
        inputs=rng.standard_normal((b, t, 24)).astype(np.float32),
        input_fracs=np.array([1.0, 0.9, 0.8, 1.0], np.float32),
        targets=rng.integers(2, vocab.n_words, (b, l)).astype(np.int32),
        target_sizes=np.array([6, 5, 4, 6], np.int32),
        trans=rng.integers(2, 16, (b, l)).astype(np.int32),
        trans_sizes=np.array([6, 5, 4, 6], np.int32),
        utt_ids=[f"u{i}" for i in range(b)])
    trainer = Trainer(cfg, device="cuda")
    wer_before = wer_cuda.greedy_wer_kernel.launches
    acc = trainer.train_step(trainer.batch_arrays(batch, np.ones(b, bool)),
                             torch.zeros(4, device="cuda"))
    torch.cuda.synchronize()
    assert wer_cuda.greedy_wer_kernel.launches == wer_before + 1
    assert acc[2].item() == 21           # the reference tokens
    session = EvalSession(cfg, trainer.model.state_dict(), vocab,
                          decode_type="Beam", beam_width=4, device="cuda")
    beam_before = beam_cuda.ctc_beam_kernel.launches
    decoded, frames = session.decode_batch(batch)
    torch.cuda.synchronize()
    assert beam_cuda.ctc_beam_kernel.launches == beam_before + 1
    assert len(decoded) == b and (frames > 0).all()


# ------------------------------------------------- the CTC loss's kernels
def _ctc_inputs(b, t, l, seed, case="random", c=43):
    """Seeded CTC inputs on the card (chip_smoke.py's recipe): log-softmax
    of N(0, 4) logits over c classes, labels 1..c-1 with a sixth repeated,
    label lengths 16..l (the train cell's 16-40), input lengths t/2..t;
    `case` adds rows of input length 0 and 1, label length 0 and rows no
    alignment fits ("edges"), the model's transposed log-probs
    ("strided"), repeats the last rows as pad_batch_to does ("padded"), or
    makes every second label its predecessor ("repeats": the skip between
    them forbidden)."""
    g = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(torch.randn((t, b, c), generator=g) * 2, -1)
    labels = torch.randint(1, c, (b, max(l, 1)), generator=g)[:, :l]
    if l > 1:
        repeat = torch.rand((b, l - 1), generator=g) < 1 / 6
        labels[:, 1:] = torch.where(repeat, labels[:, :-1], labels[:, 1:])
    label_lengths = torch.randint(min(16, l), l + 1, (b,), generator=g)
    input_lengths = torch.randint(max(1, t // 2), t + 1, (b,), generator=g)
    if case == "edges":
        input_lengths[:4] = torch.tensor([0, 0, 1, 1])
        label_lengths[:6] = torch.tensor([0, 1, 0, 1, 0, l])
        input_lengths[6] = label_lengths[6] // 2       # cannot fit
    if case == "padded":
        for x in (lp.transpose(0, 1), labels, label_lengths, input_lengths):
            x[b // 2:] = x[b // 2 - 1]
    if case == "repeats":
        labels[:, 1::2] = labels[:, 0::2][:, :l // 2]
    lp = lp.cuda()
    if case == "strided":           # log_softmax(...).transpose(0, 1)
        lp = lp.transpose(0, 1).contiguous().transpose(0, 1)
    return lp, input_lengths.cuda(), labels.cuda(), label_lengths.cuda()


CTC_SHAPES = [(64, 110, 40, "random"), (64, 47, 16, "random"),
              (64, 110, 40, "strided"), (512, 80, 40, "random"),
              (64, 110, 40, "edges"), (16, 60, 24, "padded"),
              (1, 1, 1, "random"), (3, 9, 0, "random"),
              (4, 1100, 511, "random"), (64, 110, 40, "repeats"),
              (512, 80, 40, "repeats")]


@pytest.mark.parametrize("b,t,l,case", CTC_SHAPES)
def test_ctc_kernels_match_plain_versions(cuda, b, t, l, case):
    """nll within 1e-5 relative (1e30 on rows no alignment fits), the
    alphas of each row's frames and the gradient within 1e-5: both
    versions take the same float steps in the same order (the plain
    version's class sums use atomics)."""
    from mdd_tpu_torch.ops import ctc_cuda

    args = _ctc_inputs(b, t, l, seed=b + t + l, case=case)
    launches = [k.launches for k in (ctc_cuda.ctc_alpha_kernel,
                                     ctc_cuda.ctc_beta_grad_kernel)]
    nll, alphas = ctc_cuda.ctc_loss_fwd(*args)
    g = torch.rand(b, generator=torch.Generator().manual_seed(1)).cuda() + .5
    grad = ctc_cuda.ctc_loss_bwd(*args, alphas, nll, g)
    torch.cuda.synchronize()
    assert [ctc_cuda.ctc_alpha_kernel.launches,
            ctc_cuda.ctc_beta_grad_kernel.launches] == [n + 1
                                                        for n in launches]
    ref_nll, ref_alphas = ctc_cuda.ctc_loss_fwd_reference(*args)
    ref_grad = ctc_cuda.ctc_loss_bwd_reference(*args, ref_alphas, ref_nll, g)
    torch.testing.assert_close(nll, ref_nll, rtol=1e-5, atol=0)
    frames = torch.arange(t, device="cuda")[:, None] < args[1][None]
    torch.testing.assert_close(alphas[frames], ref_alphas[frames],
                               rtol=1e-5, atol=1e-5)
    assert grad.shape == args[0].shape and torch.isfinite(grad).all()
    assert (grad - ref_grad).abs().max().item() <= 1e-5


@pytest.mark.parametrize("case", ["edges", "repeats"])
def test_ctc_kernels_are_the_same_from_run_to_run(cuda, case):
    """No float atomics: two calls give the same bits."""
    from mdd_tpu_torch.ops import ctc_cuda

    args = _ctc_inputs(64, 110, 40, seed=3, case=case)
    g = torch.ones(64, device="cuda")
    first = ctc_cuda.ctc_loss_fwd(*args)
    first_grad = ctc_cuda.ctc_loss_bwd(*args, *first[::-1], g)
    for _ in range(2):
        nll, alphas = ctc_cuda.ctc_loss_fwd(*args)
        assert torch.equal(nll, first[0])
        assert torch.equal(ctc_cuda.ctc_loss_bwd(*args, alphas, nll, g),
                           first_grad)


def test_ctc_wrappers_refuse_on_the_card(cuda):
    from mdd_tpu_torch.ops import ctc_cuda

    lp, il, labels, ll = _ctc_inputs(4, 20, 8, seed=2)
    with pytest.raises(ValueError, match="lies on"):
        ctc_cuda.ctc_alpha_kernel(lp, il.cpu(), labels, ll)
    with pytest.raises(TypeError, match="float32"):
        ctc_cuda.ctc_alpha_kernel(lp.double(), il, labels, ll)
    with pytest.raises(ValueError, match="1023"):
        ctc_cuda.ctc_alpha_kernel(lp, il, labels.repeat(1, 64), ll)


def test_float32_kernel_model_runs_every_lstm_and_the_ctc_on_kernels(cuda):
    """A float32 use_pallas_lstm Trainer step: lstm_fwd and lstm_bwd once a
    BiLSTM, the text one included (rnn_layers + 1), ctc_alpha and
    ctc_beta_grad once, no scan-contract launch; a bfloat16 step runs the
    text BiLSTM on the scan-contract kernels (lstm_scan_fwd and
    lstm_scan_bwd once, lstm_fwd and lstm_bwd rnn_layers times)."""
    from mdd_tpu_torch.data.dataset import Batch
    from mdd_tpu_torch.models.ctc_model import ModelConfig
    from mdd_tpu_torch.ops import ctc_cuda
    from mdd_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(8)
    b, t, l = 4, 40, 6
    batch = Batch(
        inputs=rng.standard_normal((b, t, 24)).astype(np.float32),
        input_fracs=np.array([1.0, 0.9, 0.8, 1.0], np.float32),
        targets=rng.integers(2, 8, (b, l)).astype(np.int32),
        target_sizes=np.array([6, 5, 4, 6], np.int32),
        trans=rng.integers(2, 16, (b, l)).astype(np.int32),
        trans_sizes=np.array([6, 5, 4, 6], np.int32),
        utt_ids=[f"u{i}" for i in range(b)])
    kernels = (lstm_cuda.lstm_fwd_kernel, lstm_cuda.lstm_bwd_kernel,
               ctc_cuda.ctc_alpha_kernel, ctc_cuda.ctc_beta_grad_kernel,
               lstm_cuda.lstm_scan_fwd_kernel, lstm_cuda.lstm_scan_bwd_kernel)
    for dtype, lstm, scan in (("float32", 3, 0), ("bfloat16", 2, 1)):
        cfg = ModelConfig(input_dim=24, num_class=8, conv_channels=(4, 4),
                          rnn_hidden_size=16, rnn_layers=2,
                          text_embed_size=8, text_vocab_size=16, dropout=0.0,
                          use_pallas_lstm=True, compute_dtype=dtype)
        trainer = Trainer(cfg, device="cuda")
        before = [k.launches for k in kernels]
        acc = trainer.train_step(trainer.batch_arrays(batch,
                                                      np.ones(b, bool)),
                                 torch.zeros(4, device="cuda"))
        torch.cuda.synchronize()
        assert [k.launches - n for k, n in zip(kernels, before)] == [
            lstm, lstm, 1, 1, scan, scan], dtype
        assert math.isfinite(acc[0].item())


# ------------------------------ the bfloat16 BiLSTMs' input projections
def _f32_sum_tol(a, b):
    """How far two float32 products of the same exact bfloat16 x bfloat16
    products may lie apart when only the order of their K float32 adds
    differs: 2^-24 (float32's unit roundoff) x sqrt(K) (rounding errors
    that add like a random walk) x (|a| @ |b|) (the size of the partial
    sums), with 16 for both results' share and the tensor cores' truncating
    adds.  A result rounded to bfloat16 (2^-9) lies far outside it."""
    k = a.shape[1]
    return 16 * k ** 0.5 * 2.0 ** -24 * (a.float().abs() @ b.float().abs())


def _bf16_ulp(v):
    """One bfloat16 ulp at |v| (8 significant bits)."""
    _, e = torch.frexp(v.float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def _rounded_close(got, want, f32_tol, *parts) -> bool:
    """Two bfloat16 roundings of float32 values at most `f32_tol` apart
    differ by at most that plus one ulp of each rounding: the result's
    and, for a sum of rounded values, each of `parts`' (float32)."""
    got, want = got.float(), want.float()
    tol = f32_tol + _bf16_ulp(torch.maximum(got.abs(), want.abs()))
    for p in parts:
        tol = tol + _bf16_ulp(p)
    return bool(((got - want).abs() <= tol).all())


def _old_projections(x, w_f, w_b, b_f, b_b):
    """The float32 SGEMM graph the bfloat16 recurrences took before."""
    xf, xb = input_projections(x, w_f, w_b)
    if b_f is not None:
        xf, xb = xf + b_f, xb + b_b
    return torch.stack([xf, xb], dim=1).to(x.dtype)


@pytest.mark.parametrize("d,bias", [(1952, False), (768, False),
                                    (512, True)])
def test_bf16_projections_on_tensor_cores_match_the_sgemm_graph(cuda, d,
                                                                bias):
    """At the flagship's widths (layer 1, layers 2-4, the text BiLSTM with
    its bias; H=384) and a small T x B: each product of Bf16Projections
    (forward, dX, dW_ih) in float32 within `_f32_sum_tol` of the SGEMM,
    and x_proj, dX, dW_ih and the bias gradients within `_rounded_close`
    of the SGEMM graph's."""
    from mdd_tpu_torch.ops import lstm

    t, b, h = 7, 5, 384
    g = torch.Generator().manual_seed(d)
    s = h ** -0.5
    leaves = [torch.randn((b, t, d), generator=g)] + [
        (torch.rand((d, 4 * h), generator=g) * 2 - 1) * s for _ in range(2)]
    leaves += [(torch.rand(4 * h, generator=g) * 2 - 1) * s
               for _ in range(2 if bias else 0)]
    leaves = [a.to("cuda").requires_grad_() for a in leaves]
    args = [leaves[0].to(torch.bfloat16).transpose(0, 1)] + [
        a.to(torch.bfloat16) for a in leaves[1:]]
    if not bias:
        args += [None, None]
    x, w_f, w_b = args[:3]
    cot = torch.randn((t, 2, b, 4 * h), generator=g).to("cuda",
                                                        torch.bfloat16)
    rows = x.reshape(t * b, d)
    rows_rev = torch.flip(rows.view(t, b, d), (0,)).reshape(t * b, d)
    gf, gb = (cot[:, k].reshape(t * b, 4 * h) for k in range(2))
    tol = {}
    for name, a, m in (("xf", rows, w_f), ("xb", rows_rev, w_b),
                       ("dxf", gf, w_f.t()), ("dxb", gb, w_b.t()),
                       ("dwf", rows.t(), gf), ("dwb", rows_rev.t(), gb)):
        got = lstm._mm_f32(a, m)
        want = a.float() @ m.float()
        tol[name] = _f32_sum_tol(a, m)
        assert got.dtype == torch.float32
        assert ((got - want).abs() <= tol[name]).all(), name

    new = lstm.projections(*args)
    old = _old_projections(*args)
    assert new.dtype == old.dtype == torch.bfloat16
    assert new.grad_fn.__class__.__name__ == "Bf16ProjectionsBackward"
    assert _rounded_close(new, old, torch.stack(
        [tol["xf"].view(t, b, -1), tol["xb"].view(t, b, -1)], dim=1))
    got = torch.autograd.grad(new, leaves, cot)
    want = torch.autograd.grad(old, leaves, cot)
    # dX: each direction's product rounded, then their bfloat16 sum
    parts = [(a.float() @ m.float()).view(t, b, d)
             for a, m in ((gf, w_f.t()), (gb, w_b.t()))]
    flip = lambda v: torch.flip(v.view(t, b, d), (0,))  # noqa: E731
    to_bt = lambda v: v.transpose(0, 1)  # noqa: E731
    assert _rounded_close(got[0], want[0],
                          to_bt(tol["dxf"].view(t, b, d) + flip(tol["dxb"])),
                          to_bt(parts[0]), to_bt(flip(parts[1])))
    assert _rounded_close(got[1], want[1], tol["dwf"])
    assert _rounded_close(got[2], want[2], tol["dwb"])
    for g_got, g_want in zip(got[3:], want[3:]):
        assert _rounded_close(g_got, g_want, 0.0)


def test_bf16_step_of_the_baseline_runs_no_float32_product(cuda):
    """A profiled bfloat16 Trainer step of the baseline model (the
    flagship's acoustic encoder, no text branch) launches no float32
    product: no cuBLAS kernel named `f32f32_f32f32`, no CUTLASS or cuBLAS
    `sgemm` (cuDNN's `implicit_convolve_sgemm<__nv_bfloat16, ...>` is the
    bfloat16 convolution, not one)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from mdd_tpu_torch.data.dataset import Batch
    from mdd_tpu_torch.models.ctc_model import ModelConfig
    from mdd_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(9)
    b, t, l = 8, 120, 12
    batch = Batch(
        inputs=rng.standard_normal((b, t, 243)).astype(np.float32),
        input_fracs=np.ones(b, np.float32),
        targets=rng.integers(2, 43, (b, l)).astype(np.int32),
        target_sizes=np.full(b, l, np.int32),
        trans=rng.integers(2, 43, (b, l)).astype(np.int32),
        trans_sizes=np.full(b, l, np.int32),
        utt_ids=[f"u{i}" for i in range(b)])
    cfg = ModelConfig(use_text_attention=False, use_pallas_lstm=True,
                      compute_dtype="bfloat16")
    trainer = Trainer(cfg, device="cuda")
    arrays = trainer.batch_arrays(batch, np.ones(b, bool))
    acc = torch.zeros(4, device="cuda")
    trainer.train_step(arrays, acc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_step(arrays, acc)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("lstm_bwd" in n for n in names)
    assert not [n for n in names if re.search(
        r"(?<!implicit_convolve_)sgemm|f32f32_f32f32", n)]
