"""The port's device-resident corpus (mdd_tpu_torch/data/device_cache.py) vs
mdd_tpu's on the same tiny corpus, written by the port's ArkScpWriter:
the CachedLoader's batches field for field, the gathered and masked
features in float32 and on the bfloat16 wire, `bulk_load`; then the
port's own paths: a train epoch over the cache against one over the
streaming loader, `train --device cpu` with `device_cache: true` and its
`--resume`, and `evaluate --cached` against the streaming `evaluate`."""

import dataclasses
import json
import re

import ml_dtypes
import numpy as np
import pytest
import torch

from mdd_tpu.data.dataset import SpeechDataset as JaxDataset
from mdd_tpu.data.device_cache import CachedLoader as JaxCachedLoader
from mdd_tpu.data.device_cache import DeviceFeatureCache as JaxCache
from mdd_tpu.data.device_cache import make_cache_assemble
from mdd_tpu.data.vocab import Vocab as JaxVocab
from mdd_tpu.frontend.augment import \
    apply_spec_augment_masks as jax_apply_masks
from mdd_tpu.parallel.mesh import make_mesh
from mdd_tpu_torch import cli
from mdd_tpu_torch.data.dataset import BucketedLoader, SpeechDataset
from mdd_tpu_torch.data.device_cache import (CachedBatch, CachedLoader,
                                             DeviceFeatureCache)
from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.evals.evaluate import EvalSession
from mdd_tpu_torch.frontend import kaldi_io
from mdd_tpu_torch.frontend.augment import apply_spec_augment_masks
from mdd_tpu_torch.models.ctc_model import CTCAttentionModel, ModelConfig
from mdd_tpu_torch.train.checkpoint import save_checkpoint
from mdd_tpu_torch.train.loop import Trainer
from mdd_tpu_torch.utils.config import load_config
from test_torch_data import UNITS, write_corpus
from test_torch_train_cli import _train, _yaml

FIELDS = ("idx", "lengths", "aug", "targets", "target_sizes", "trans",
          "trans_sizes", "valid")
TQ = 8                      # time_quantum: raw buckets of 16 frames
DS_KW = dict(augment_mode=2, mutation_prob=0.3, device_frontend=True)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """23 utterances of 3-8 phones, 3-14 frames a phone: several buckets,
    ragged tails in each."""
    root = tmp_path_factory.mktemp("cache_corpus")
    return write_corpus(root, "train", 23, seed=4, frames=(3, 15))


def _pair(corpus, train, wire_dtype="float32", batch_size=4, shuffle=True,
          seed=7):
    """(port loader, mdd_tpu loader) over one corpus and seed; mdd_tpu's
    cache on a one-device mesh, unsharded, as the port's."""
    ours = CachedLoader(
        DeviceFeatureCache(SpeechDataset(Vocab(UNITS), *corpus, train=train,
                                         **DS_KW), "cpu",
                           time_quantum=TQ, wire_dtype=wire_dtype),
        batch_size, shuffle=shuffle, seed=seed, label_quantum=4)
    mesh = make_mesh(1)
    ref = JaxCachedLoader(
        JaxCache(JaxDataset(JaxVocab(UNITS), *corpus, train=train, **DS_KW),
                 mesh=mesh, time_quantum=TQ, wire_dtype=wire_dtype,
                 shard_rows=False),
        batch_size, shuffle=shuffle, seed=seed, label_quantum=4)
    return ours, ref


def _assert_batches_equal(ours, ref):
    assert ours.bucket == ref.bucket
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f),
                                      err_msg=f)
        assert getattr(ours, f).dtype == getattr(ref, f).dtype, f
    assert ours.utt_ids == ref.utt_ids


@pytest.mark.parametrize("case", ["train-two-epochs", "train-set-epoch",
                                  "eval-ragged-tail"])
def test_cached_loader_batches_equal_mdd_tpu(corpus, case):
    """Field for field: two shuffled, augmented train epochs; one epoch
    after set_epoch (a resumed run); one eval epoch whose buckets end in
    ragged tails padded with valid=False rows."""
    train = case.startswith("train")
    ours, ref = _pair(corpus, train, shuffle=train)
    assert len(ours) == len(ref) and ours.cache.raw_quantum == 16
    if case == "train-set-epoch":
        ours.set_epoch(5)
        ref.set_epoch(5)
    epochs = 2 if case == "train-two-epochs" else 1
    n_valid = 0
    for _ in range(epochs):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want):
            _assert_batches_equal(a, b)
            assert a.size == 4
            n_valid += int(a.valid.sum())
            if train:
                assert (a.aug[a.valid] != 0).any()
    assert n_valid == 23 * epochs
    if not train:
        assert any(not b.valid.all() for b in got)
        assert all(not b.aug.any() for b in got)
    np.testing.assert_array_equal(ours.cache.row_of, ref.cache.row_of)
    np.testing.assert_array_equal(ours.cache.lengths, ref.cache.lengths)
    assert ours.cache.bytes == ref.cache.bytes


def test_shuffle_covers_every_item_once_an_epoch(corpus):
    ours, _ = _pair(corpus, True, seed=11)
    orders = []
    for _ in range(2):
        seen = [u for b in ours for u, v in zip(b.utt_ids, b.valid) if v]
        assert sorted(seen) == sorted(it[0] for it in ours.ds.items)
        orders.append(seen)
    assert orders[0] != orders[1]


@pytest.mark.parametrize("wire_dtype", ["float32", "bfloat16"])
def test_gathered_masked_features_equal(corpus, wire_dtype):
    """Each batch gathered and masked by the port equals mdd_tpu's
    make_cache_assemble(mesh, False) + apply_spec_augment_masks, and
    equals bit for bit the streaming path's item (SpeechDataset.load_item
    with the item's Generator, on the wire dtype) padded to the bucket."""
    ours, ref = _pair(corpus, True, wire_dtype=wire_dtype)
    assemble = make_cache_assemble(ref.cache.mesh, sharded=False)
    dtype = torch.float32 if wire_dtype == "float32" else torch.bfloat16
    epoch = ours._epoch
    for a, b in zip(ours, ref):
        inputs, fracs = ours.cache.gather(a)
        np.testing.assert_array_equal(
            torch.round(fracs * a.bucket).numpy(), a.lengths)
        got = apply_spec_augment_masks(inputs, torch.as_tensor(a.aug))
        assert got.dtype == dtype and got.shape[1] == a.bucket
        want = np.asarray(jax_apply_masks(
            assemble(ref.cache.buckets[b.bucket], b.idx), b.aug))
        if wire_dtype == "bfloat16":
            assert want.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))
        for k in np.flatnonzero(a.valid):
            i = next(j for j, it in enumerate(ours.ds.items)
                     if it[0] == a.utt_ids[k])
            feat, _, trans, _ = ours.ds.load_item(
                i, np.random.default_rng((ours.seed + epoch, i)))
            host = torch.zeros((a.bucket, feat.shape[1]), dtype=dtype)
            host[:feat.shape[0]] = torch.from_numpy(feat)
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            assert torch.equal(got[k].view(bits), host.view(bits))
            assert list(a.trans[k][:a.trans_sizes[k]]) == trans


def test_masks_zero_the_host_entries():
    feats = torch.arange(2 * 6 * 5, dtype=torch.float32).reshape(2, 6, 5) - 30
    params = torch.tensor([[2, 1, 3, 2], [0, 0, 0, 0]], dtype=torch.int32)
    got = apply_spec_augment_masks(feats, params)
    want = feats.clone()
    want[0, :, 1:3] = 0
    want[0, 2:5, :] = 0
    assert torch.equal(got, want)
    assert not torch.signbit(got[0]).logical_and(got[0] == 0).any()


def test_bulk_load_equals_load_mat(corpus, tmp_path):
    """Entry by entry, in input order; a bare ark path is its first
    matrix; an offset the pass does not meet falls back to load_mat."""
    scp = kaldi_io.read_scp(corpus[0])
    rxs = list(scp.values())[::-1]
    ark = rxs[0].rsplit(":", 1)[0]
    other = tmp_path / "other.ark"
    with kaldi_io.ArkScpWriter(str(other)) as w:
        w.write("x", np.ones((3, 81), np.float32))
    got = kaldi_io.bulk_load(rxs + [ark, str(other)])
    for rx, mat in zip(rxs + [ark, str(other)], got):
        np.testing.assert_array_equal(mat, kaldi_io.load_mat(rx))
    assert got[-1].shape == (3, 81)
    with pytest.raises(ValueError):
        kaldi_io.bulk_load([f"{ark}:3"])


def test_refusals(corpus):
    ds = SpeechDataset(Vocab(UNITS), *corpus)
    with pytest.raises(ValueError, match="device_frontend"):
        DeviceFeatureCache(ds, "cpu")
    ours, _ = _pair(corpus, False)
    # several processes are ported (tests/test_torch_distributed.py); a
    # rank outside the group is refused
    with pytest.raises(ValueError, match="process_index 2"):
        CachedLoader(ours.cache, 4, process_index=2, process_count=2)


TINY = dict(input_dim=243, num_class=len(UNITS) + 2, conv_channels=(4, 4),
            rnn_hidden_size=16, rnn_layers=2, text_embed_size=8,
            text_vocab_size=len(UNITS) + 4, use_pallas_lstm=True,
            dropout=0.0)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_cached_epoch_equals_streaming_epoch(tmp_path, train):
    """One port epoch over the cache and one over the streaming loader,
    same weights, dropout 0: one utterance length, so both loaders form the
    same batches, and everything else (augmentation streams, masks, splice,
    the ragged tail's padding) must line up: loss within 1e-5, WER
    equal."""
    corpus = write_corpus(tmp_path, "same", 10, seed=3, min_phones=5,
                          max_phones=6, frames=(8, 9))
    out = {}
    for cached in (False, True):
        ds = SpeechDataset(Vocab(UNITS), *corpus, train=train, **DS_KW)
        loader = (CachedLoader(DeviceFeatureCache(ds, "cpu", time_quantum=TQ,
                                                  wire_dtype="bfloat16"),
                               4, seed=2, label_quantum=4) if cached
                  else BucketedLoader(ds, 4, seed=2, time_quantum=TQ,
                                      label_quantum=4,
                                      wire_dtype="bfloat16"))
        trainer = Trainer(ModelConfig(**TINY), seed=5, device="cpu",
                          device_frontend=True)
        out[cached] = trainer.run_epoch(loader, 1, train,
                                        log=lambda *_: None)
    assert out[True][0] == out[False][0]
    assert out[True][1] == pytest.approx(out[False][1], abs=1e-5, rel=1e-5)


def test_train_cli_on_the_device_cache_and_resume(tmp_path, capsys,
                                                  monkeypatch):
    """`train --device cpu` on `device_cache: true` for one epoch (a
    process of its own), then `--resume` for a second (in this one):
    `latest` at epoch 2, losses finite, and the resumed epoch ran the
    batches of a fresh train loader at set_epoch(1)."""
    out = _train(_yaml(tmp_path, 1, device_cache=True))
    assert "Epoch 1 Train done" in out and "Epoch 1 Valid done" in out
    ran = []
    make_batch = CachedLoader._make_batch

    def record(self, bucket, chunk, epoch):
        if self.shuffle:                 # the train loader's batches
            ran.append((bucket, list(chunk)))
        return make_batch(self, bucket, chunk, epoch)

    monkeypatch.setattr(CachedLoader, "_make_batch", record)
    conf = _yaml(tmp_path, 2, device_cache=True)
    assert cli.main(["train", "--conf", conf, "--device", "cpu",
                     "--resume"]) == 0
    out2 = capsys.readouterr().out
    assert "resumed from epoch 1" in out2
    assert "Start training epoch: 2" in out2
    assert "Start training epoch: 1," not in out2
    meta = json.loads((tmp_path / "ckpt" / "tiny" / "latest.meta.json"
                       ).read_text())
    assert meta["epoch"] == 2 and len(meta["loss_results"]) == 2
    assert all(np.isfinite(meta["loss_results"]))
    cfg = load_config(conf)
    fresh = cli._build_loader(cfg, Vocab.from_units_file(cfg.vocab_file),
                              cfg.train_scp_path, cfg.train_lab_path,
                              cfg.train_trans_path, train=True, device="cpu")
    assert isinstance(fresh, CachedLoader)
    assert ran == fresh.schedule(1) != fresh.schedule(0)


def _eval_conf(tmp_path, batch_size=4):
    cfg = ModelConfig(**TINY)
    model = CTCAttentionModel(cfg)
    model.init_parameters(torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path / "ckpt" / "tiny"), "best",
                    model.state_dict(),
                    {"model_config": dataclasses.asdict(cfg)})
    (tmp_path / "units").write_text("\n".join(UNITS) + "\n")
    scp, lab, trans = write_corpus(tmp_path / "data", "test", 13, seed=9,
                                   frames=(3, 15))
    fields = dict(
        exp_name="tiny", checkpoint_dir=str(tmp_path / "ckpt"),
        vocab_file=str(tmp_path / "units"), test_scp_path=scp,
        test_lab_path=lab, test_trans_path=trans, decode_type="Beam",
        beam_width=4, device_frontend=True, wire_dtype="bfloat16",
        batch_size=batch_size, num_workers=2, time_quantum=TQ,
        label_quantum=4)
    path = tmp_path / f"eval{batch_size}.yaml"
    path.write_text("".join(f"{k}: {json.dumps(v)}\n"
                            for k, v in fields.items()))
    return str(path)


def _evaluate(capsys, conf, dump, *flags):
    """-> (the report without its timing line, {dump file: {utt: line}})."""
    assert cli.main(["evaluate", "--conf", conf, "--device", "cpu",
                     "--dump-dir", str(dump), *flags]) == 0
    report = capsys.readouterr().out.split("time used for decode")[0]
    assert "TA :  " in report
    return report, {f.name: dict(line.split(" ", 1) for line in
                                 f.read_text().splitlines())
                    for f in sorted(dump.iterdir())}


def _widths(loader):
    """utt -> (feature width, canonical-transcript width) of its batch."""
    out = {}
    for b in loader:
        width = b.bucket if isinstance(b, CachedBatch) else b.inputs.shape[1]
        for utt in b.utt_ids:
            out.setdefault(utt, (width, b.trans.shape[1]))
    return out


@pytest.mark.parametrize("decode", ["Beam", "Greedy"])
def test_evaluate_cached_equals_streaming(tmp_path, capsys, decode):
    """At batch size 1 both loaders pad an utterance to the same widths,
    so `evaluate --cached --device cpu` prints the streaming `evaluate`'s
    report (PER, TA/FR/FA/TR, F1) and writes its dump lines."""
    conf = _eval_conf(tmp_path, batch_size=1)
    flags = ("--decode-type", decode)
    stream = _evaluate(capsys, conf, tmp_path / "stream", *flags)
    cached = _evaluate(capsys, conf, tmp_path / "cached", "--cached", *flags)
    assert cached == stream and len(stream[1]["decode_seq.log"]) == 13


def test_evaluate_cached_differs_only_where_the_padding_does(tmp_path,
                                                             capsys):
    """At batch size 4 the cached batches group utterances by bucket and
    the streaming ones by sorted length, so some utterances are padded to
    other widths.  The model's outputs depend on the padding (the
    backward directions of the acoustic and the text BiLSTM run over it,
    in mdd_tpu as in the port), so only the utterances padded alike must
    decode alike; the label and canonical tallies never move."""
    conf = _eval_conf(tmp_path)
    stream = _evaluate(capsys, conf, tmp_path / "stream")
    cached = _evaluate(capsys, conf, tmp_path / "cached", "--cached")
    cfg = load_config(conf)
    cfg.device_frontend = True
    vocab = Vocab.from_units_file(cfg.vocab_file)
    split = (cfg.test_scp_path, cfg.test_lab_path, cfg.test_trans_path)
    w_stream = _widths(cli._build_loader(cfg, vocab, *split, train=False,
                                         device="cpu"))
    cfg.device_cache = True
    w_cached = _widths(cli._build_loader(cfg, vocab, *split, train=False,
                                         device="cpu"))
    alike = [u for u in w_stream if w_stream[u] == w_cached[u]]
    assert 0 < len(alike) < 13
    for name in ("human_seq.log", "transcribe.log"):
        assert cached[1][name] == stream[1][name]
    for utt in alike:
        assert cached[1]["decode_seq.log"][utt] == \
            stream[1]["decode_seq.log"][utt]
    for pattern in (r"total_phoneme: \d+", r"total :  \d+ "):
        assert re.findall(pattern, cached[0]) == re.findall(pattern,
                                                             stream[0])


def test_evaluate_cached_needs_the_device_frontend(tmp_path):
    conf = _eval_conf(tmp_path)
    text = open(conf).read().replace("device_frontend: true",
                                     "device_frontend: false").replace(
        'wire_dtype: "bfloat16"\n', "")
    (tmp_path / "host.yaml").write_text(text)
    with pytest.raises(SystemExit, match="device_frontend"):
        cli.main(["evaluate", "--conf", str(tmp_path / "host.yaml"),
                  "--device", "cpu", "--cached"])


def test_cached_batch_needs_attach_cache(corpus):
    ours, _ = _pair(corpus, False)
    cfg = ModelConfig(**TINY)
    model = CTCAttentionModel(cfg)
    model.init_parameters(torch.Generator().manual_seed(1))
    session = EvalSession(cfg, model.state_dict(),
                          Vocab(UNITS), device="cpu", device_frontend=True)
    batch = next(iter(ours))
    assert isinstance(batch, CachedBatch)
    with pytest.raises(ValueError, match="attach_cache"):
        session.decode_batch(batch)
    session.attach_cache(ours.cache)
    decoded, frames = session.decode_batch(batch)
    assert len(decoded) == batch.size and (frames > 0).all()
