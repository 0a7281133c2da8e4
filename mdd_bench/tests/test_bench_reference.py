"""The plain reference against the port's CPU path at a small size: the
batches field for field, the splice bit for bit, and in float32 one run's
comparison numbers at float32 rounding."""

import numpy as np
import torch

from mdd_bench import corpus, harness, manifest, reference
from mdd_bench.tests import small


def _cfg(**kw):
    return dict(manifest.config("attention_aug"), **small.CFG, **kw)


def _mix():
    return dict(manifest.traffic("train_b256"), **small.MIX)


def test_batches_equal_the_cached_loaders(tmp_path):
    from mdd_tpu_torch import cli
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.frontend.augment import apply_spec_augment_masks

    cfg, mix, seed = _cfg(), _mix(), 2 ** 31 + 5
    data = corpus.generate(mix, cfg["units"], seed)
    paths = corpus.write(data, tmp_path)
    port = harness._port_config(cfg, mix, seed, paths)
    vocab = Vocab.from_units_file(paths["vocab_file"])
    loader = cli._build_loader(port, vocab, paths["train_scp_path"],
                               paths["train_lab_path"],
                               paths["train_trans_path"], train=True,
                               device="cpu")
    want = reference.first_batches(data, cfg, mix, seed, 100)
    got = list(loader)
    assert len(got) == len(want) == len(loader)
    for g, w in zip(got, want):
        assert g.bucket == w.bucket
        for f in ("lengths", "aug", "targets", "target_sizes", "trans",
                  "trans_sizes", "valid"):
            assert np.array_equal(getattr(g, f), getattr(w, f)), f
        inputs, _ = loader.cache.gather(g)
        masked = apply_spec_augment_masks(inputs, torch.as_tensor(g.aug))
        assert torch.equal(masked, reference.raw_inputs(data, w, "cpu"))


def test_splice_equals_the_ports():
    from mdd_tpu_torch.frontend.splice import batched_splice_skip

    cfg = _cfg()
    raw = torch.randn(5, 256, 81)
    lengths = torch.tensor([256, 200, 151, 1, 97])
    raw = raw * (torch.arange(256)[None] < lengths[:, None])[..., None]
    x, frames = reference.splice(raw, lengths, cfg)
    y, f2 = batched_splice_skip(raw, lengths, 0, 2, 2, 2)
    assert torch.equal(x, y) and torch.equal(frames, f2)


def test_float32_run_agrees_at_float32_rounding():
    res = harness.run_cell(
        small.CELL, 31, 0.0, False, device="cpu",
        cfg_override=dict(small.CFG, compute_dtype="float32"),
        mix_override=dict(small.MIX, warmup_epochs=0))
    c = {k: v["value"] for k, v in res["checks"].items()}
    assert c["batch_mismatch"] == 0 and c["wer_count_gap"] == 0
    assert c["logprob_gap"] < 1e-4
    assert c["loss_gap"] < 1e-5
    assert c["grad_gap"] < 1e-3
    assert c["update_gap"] < 1e-3
