"""The yardstick's arithmetic against hand-worked values and the port's
own count."""

import pytest

from mdd_bench import flops, manifest


def test_train_step_flops_is_the_ports():
    from mdd_tpu_torch.bench import train_step_flops
    from mdd_tpu_torch.utils.config import Config

    for name in ("attention_aug", "cnn_rnn_ctc"):
        cfg = manifest.config(name)
        port = Config(use_text_attention=cfg["use_text_attention"])
        mc = port.model_config(len(cfg["units"]) + 2)
        for b, t, l in ((1, 48, 20), (256, 256, 64), (3, 7, 1)):
            assert flops.train_step_flops(cfg, b, t, l) == pytest.approx(
                train_step_flops(mc, b, t, l), rel=1e-12)


def test_a_tiny_step_by_hand():
    cfg = {"family": "cnn_bilstm", "feature_dim": 1, "left_ctx": 0,
           "right_ctx": 0, "kernel_size": [[1, 1]], "stride": [[1, 1]],
           "padding": [[0, 0]], "channel": [[1, 1]], "rnn_hidden_size": 1,
           "rnn_layers": 1, "use_text_attention": False, "units": ["a"]}
    # conv 2*t*f*ch*kt*kf*cin = 2*2; one BiLSTM layer 2*t*2*(1*4 + 1*4) =
    # 64; head 2*t*2h*classes = 2*2*2*3 = 24; x3 for the backward
    assert flops.train_step_flops(cfg, 1, 2, 0) == 3 * (4 + 64 + 24)


def test_lstm_work_by_hand():
    # T=2, B=1, H=1, float32: 2*T*2*B*H*4H = 32 operations; projections
    # T*2*B*4H = 16, W_hh 2*H*4H = 8, hs + cs 2*T*2*B*H = 8 elements
    assert flops.lstm_fwd_work(2, 1, 1, "float32") == (32.0, 128)
    # three products; + dhs 4 (float32) + dx_proj 16 + dW_hh 8 (float32)
    ops, byts = flops.lstm_bwd_work(2, 1, 1, "float32")
    assert ops == 96.0
    assert byts == (16 + 8 + 8) * 4 + 4 * 4 + 16 * 4 + 8 * 4


def test_least_time_and_shapes():
    card = flops.H100_SXM
    ops, byts = flops.lstm_fwd_work(128, 256, 384, "bfloat16")
    least = flops.least_seconds(ops, byts, card, "bfloat16")
    assert least == pytest.approx(max(ops / 989e12, byts / 3.35e12))
    assert flops.least_seconds(ops, byts, "cpu", "bfloat16") is None
    cfg = manifest.config("attention_aug")
    assert flops.recurrence_steps(cfg, 512) == 128
    assert flops.recurrence_steps(cfg, 256) == 64
    assert flops.model_frames(cfg, 151) == 76
    assert flops.model_frames(cfg, 153) == 78
