"""The CUDA kernels on the card (the LSTM recurrences and the fused
dropout): against their plain versions, the refusals of the wrappers, and
autograd through the backward kernels.
Marked `cuda`; skips where there is no card.
No JAX here, so the file runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import sys
import threading

import numpy as np
import pytest
import torch

from mdd_tpu_torch.ops import dropout_cuda, lstm_cuda
from mdd_tpu_torch.ops.lstm import bilstm
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


@pytest.mark.parametrize("kernel", ["lstm_fwd", "lstm_bwd"])
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


@pytest.fixture
def second_card(cuda):
    """cuda:1 where the host has two cards; the current device stays 0,
    as in a rank of the local mesh whose tensors lie on another card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    torch.cuda.set_device(0)
    return torch.device("cuda", 1)


@pytest.mark.parametrize("kernel", ["lstm_fwd", "lstm_bwd"])
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
    if kernel == "lstm_fwd":
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
