"""The port's reader of mdd_tpu's orbax checkpoints
(mdd_tpu_torch/train/orbax_format.py) against orbax and tensorstore, which
only this test imports: the committed checkpoint `checkpoints/syn_full/best`
leaf for leaf and bit for bit, its bridged state dict, stores tensorstore
writes with interior b-tree nodes, many versions, several chunks a
dimension and every supported dtype, a small model's `best` and `latest`
from mdd_tpu's own save_checkpoint, the refusals (a flipped byte, a
truncated file, a missing chunk, an unknown codec or dtype, no libzstd),
and `evaluate` / `serve` on the CPU straight from the orbax directory."""

import dataclasses
import io
import json
import os
import re
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch

from mdd_tpu.cli import _build_loader as jax_build_loader
from mdd_tpu.cli import _model_config_from_meta
from mdd_tpu.data.vocab import Vocab as JaxVocab
from mdd_tpu.evals.evaluate import EvalSession as JaxEvalSession
from mdd_tpu.evals.evaluate import evaluate_model as jax_evaluate_model
from mdd_tpu.train import checkpoint as jax_checkpoint
from mdd_tpu.utils.config import load_config as jax_load_config
from mdd_tpu_torch import cli
from mdd_tpu_torch.convert import flax_to_torch
from mdd_tpu_torch.lexicon.phones import CANONICAL_UNITS_41
from mdd_tpu_torch.train import orbax_format
from mdd_tpu_torch.train.checkpoint import (checkpoint_format,
                                            load_checkpoint, save_checkpoint)
from mdd_tpu_torch.train.orbax_format import (OcdbtStore, OrbaxFormatError,
                                              load_mdd_tpu_checkpoint,
                                              read_orbax_checkpoint,
                                              read_zarr_array)

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "checkpoints" / "syn_full"
# small nodes, so that a few dozen keys make a tree of interior nodes
SMALL_NODES = {"max_inline_value_bytes": 16, "max_decoded_node_bytes": 256,
               "manifest_kind": "single"}


def _paths(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.fixture(scope="module")
def orbax_best():
    if not (CKPT / "best").exists():
        pytest.skip("committed checkpoint missing")
    state, meta = jax_checkpoint.load_checkpoint(str(CKPT), "best")
    return jax.device_get(state), meta


def test_committed_checkpoint_reads_as_orbax_restores_it(orbax_best):
    ours = read_orbax_checkpoint(str(CKPT / "best"))
    want = orbax_best[0]
    assert (jax.tree_util.tree_structure(ours)
            == jax.tree_util.tree_structure(want))
    leaves = list(zip(_paths(ours), _paths(want)))
    assert len(leaves) == 53
    for (path, a), (_, b) in leaves:
        b = np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path
    assert len(OcdbtStore(str(CKPT / "best")).keys()) == 106


def test_load_mdd_tpu_checkpoint_is_the_bridge_of_orbax(orbax_best):
    state, meta = load_mdd_tpu_checkpoint(str(CKPT), "best")
    want = flax_to_torch(orbax_best[0]["params"],
                         orbax_best[0]["batch_stats"])
    assert state.keys() == want.keys()
    assert all(torch.equal(state[k], want[k]) for k in want)
    assert meta == orbax_best[1] and meta["epoch"] == 84
    # load_checkpoint takes the orbax directory where there is no .pt
    assert checkpoint_format(str(CKPT), "best") == "orbax"
    via, meta2 = load_checkpoint(str(CKPT), "best")
    assert meta2 == meta and all(torch.equal(via[k], want[k]) for k in want)


def test_port_checkpoint_wins_over_orbax_and_neither_raises(tmp_path):
    state, meta = load_checkpoint(str(CKPT), "best")
    shutil.copytree(CKPT / "best", tmp_path / "best",
                    copy_function=os.symlink)
    first = {k: v + 1 for k, v in state.items()}
    save_checkpoint(str(tmp_path), "best", first, meta)
    assert checkpoint_format(str(tmp_path), "best") == "torch"
    got, _ = load_checkpoint(str(tmp_path), "best")
    assert all(torch.equal(got[k], first[k]) for k in first)
    with pytest.raises(FileNotFoundError,
                       match=r"neither the port's .*other\.pt nor "
                             r"mdd_tpu's orbax directory"):
        load_checkpoint(str(tmp_path), "other")


@pytest.mark.parametrize("given", ["syn_full", "syn_full/best"])
def test_checkpoint_flag_takes_the_directory_or_best_itself(given):
    cfg = type("Cfg", (), {"checkpoint_dir": "unused", "exp_name": "x"})
    state, model_cfg = cli._load_best(cfg, str(ROOT / "checkpoints" / given))
    assert len(state) == 53 and model_cfg.num_class == 43
    assert model_cfg.rnn_layers == 4 and model_cfg.rnn_hidden_size == 384


# ------------------------------------------------ stores tensorstore writes

ARRAYS = {
    "f4_ragged": (np.random.default_rng(0).standard_normal((7, 5, 3))
                  .astype(np.float32), [3, 2, 2], "<f4", "zstd"),
    "f2": (np.random.default_rng(1).standard_normal((9, 4))
           .astype(np.float16), [4, 3], "<f2", "zstd"),
    "i4": (np.arange(-20, 17, dtype=np.int32).reshape(37), [10], "<i4",
           None),
    "i8": (np.arange(11, dtype=np.int64) * 10 ** 12, [4], "<i8", "zstd"),
    "u1": (np.arange(30, dtype=np.uint8).reshape(5, 6), [2, 4], "|u1",
           "zstd"),
    "b1": (np.random.default_rng(2).random((5, 4)) > 0.5, [2, 3], "|b1",
           "zstd"),
    "scalar": (np.array(3.5, np.float32), [], "<f4", "zstd"),
    "bf16": (np.random.default_rng(3).standard_normal((6, 5))
             .astype(np.float32), [4, 4], "bfloat16", None),
}


def _zarr_spec(root: Path, name: str, shape, chunks, dtype, compressor,
               node_config=SMALL_NODES):
    return {"driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": f"file://{root}/",
                        "config": node_config, "path": f"{name}/"},
            "metadata": {"shape": list(shape), "chunks": chunks,
                         "dtype": dtype,
                         "compressor": ({"id": "zstd", "level": 1}
                                        if compressor == "zstd"
                                        else compressor)}}


@pytest.fixture(scope="module")
def zarr_store(tmp_path_factory):
    """Every ARRAYS entry, plus filler arrays so the b-tree has interior
    nodes; -> (root, {name: the values tensorstore reads back})."""
    root = tmp_path_factory.mktemp("zarr_store")
    want = {}
    for name, (value, chunks, dtype, comp) in ARRAYS.items():
        t = ts.open(_zarr_spec(root, name, value.shape, chunks, dtype, comp),
                    create=True).result()
        t.write(value.astype(t.dtype.numpy_dtype)).result()
        want[name] = np.asarray(t.read().result())
    for i in range(24):
        filler = ts.open(_zarr_spec(root, f"filler{i:02d}", [3], [2], "<i4",
                                    "zstd"), create=True).result()
        filler.write(np.arange(3, dtype=np.int32) + i).result()
    return root, want


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_zarr_arrays_of_a_deep_store_read_back(zarr_store, name,
                                               monkeypatch):
    root, want = zarr_store
    nodes = []
    read_node = OcdbtStore._read_node

    def counted(self, *args):
        nodes.append(args[3])                       # each node's height
        return read_node(self, *args)

    monkeypatch.setattr(OcdbtStore, "_read_node", counted)
    store = OcdbtStore(str(root))
    assert max(nodes) >= 2 and len(nodes) > 10      # interior nodes
    got = read_zarr_array(store, name)
    value, chunks, dtype, _ = ARRAYS[name]
    ref = want[name]
    if dtype == "bfloat16":
        # widened exactly: the float32 of tensorstore's bfloat16 values
        assert got.dtype == np.float32
        ref = ref.astype(np.float32)
        assert not np.array_equal(ref, value)       # rounding happened
    else:
        assert got.dtype == value.dtype
    assert got.shape == value.shape
    assert got.tobytes() == ref.tobytes()
    assert read_zarr_array(store, "filler07").tolist() == [7, 8, 9]


def test_many_versions_read_the_newest(tmp_path):
    """Sixty commits with a version-tree arity of 4: the manifest keeps
    older versions in version-tree nodes, the newest inline."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": dict(SMALL_NODES,
                                         version_tree_arity_log2=2)}).result()
    for i in range(60):
        kv.write(f"k{i % 7}", f"value {i}".encode()).result()
    store = OcdbtStore(str(tmp_path))
    assert store.keys() == [f"k{j}" for j in range(7)]
    for j in range(7):
        last = max(i for i in range(60) if i % 7 == j)
        assert store.get(f"k{j}") == f"value {last}".encode()


def test_merged_per_process_store_reads_back(tmp_path):
    """orbax's layout: a per-process store under ocdbt.process_0/ copied
    into the root store, whose nodes then name that directory's files."""
    ctx = ts.Context({"cache_pool#ocdbt": {"total_bytes_limit": 10 ** 8}})

    def open_kv(path):
        return ts.KvStore.open({"driver": "ocdbt",
                                "base": {"driver": "file", "path": path},
                                "config": SMALL_NODES,
                                "cache_pool": "cache_pool#ocdbt"},
                               context=ctx).result()

    child = open_kv(str(tmp_path / "ocdbt.process_0"))
    rng = np.random.default_rng(4)
    want = {f"arr{i:03d}/{i % 5}.{i % 3}":
            rng.integers(0, 256, i % 40, dtype=np.uint8).tobytes()
            for i in range(90)}
    for k, v in want.items():
        child.write(k, v).result()
    txn = ts.Transaction(atomic=True)
    child.experimental_copy_range_to(
        open_kv(str(tmp_path)).with_transaction(txn)).result()
    txn.commit_sync()
    store = OcdbtStore(str(tmp_path))
    assert store.keys() == sorted(want)
    assert all(store.get(k) == v for k, v in want.items())


# ------------------------------------ mdd_tpu's own save_checkpoint, small

@pytest.fixture(scope="module")
def small_saves(tmp_path_factory):
    """A 2-layer model's `best` and `latest` (with optax's Adam state)
    written by mdd_tpu's Trainer after one step."""
    from mdd_tpu.train.loop import Trainer
    from test_resume import _batch, _tiny_cfg

    root = tmp_path_factory.mktemp("small_saves")
    cfg = _tiny_cfg()
    trainer = Trainer(cfg, n_devices=1, sample_t=16, sample_l=3)
    trainer.run_epoch([_batch(np.random.default_rng(0), cfg)], 1, True,
                      log=lambda *_: None)
    for tag in ("best", "latest"):
        trainer.save(str(root), "exp", tag, epoch=1)
    return root / "exp"


@pytest.mark.parametrize("tag", ["best", "latest"])
def test_small_model_saves_read_back(small_saves, tag):
    want, meta = jax_checkpoint.load_checkpoint(str(small_saves), tag)
    want = jax.device_get(want)
    ours = read_orbax_checkpoint(str(small_saves / tag))
    assert (jax.tree_util.tree_structure(ours)
            == jax.tree_util.tree_structure(want))
    for (path, a), (_, b) in zip(_paths(ours), _paths(want)):
        b = np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path
    if tag == "latest":
        assert ours["opt_state"]["inner_state"][0] is None
        assert ours["opt_state"]["count"].dtype == np.int32
    state, meta2 = load_mdd_tpu_checkpoint(str(small_saves), tag)
    assert meta2 == meta
    expect = flax_to_torch(want["params"], want["batch_stats"])
    assert all(torch.equal(state[k], expect[k]) for k in expect)


def test_a_leaf_the_bridge_cannot_map_raises(tmp_path):
    params, stats, _ = _small_variables()
    params = dict(params, extra={"kernel": np.ones((2, 2), np.float32)})
    jax_checkpoint.save_checkpoint(str(tmp_path), "best", params, stats,
                                   {"epoch": 1})
    with pytest.raises(ValueError, match=r"unknown leaves \['extra/kernel'"):
        load_mdd_tpu_checkpoint(str(tmp_path), "best")


def _small_variables():
    from mdd_tpu.models.ctc_model import CTCAttentionModel
    from test_resume import _tiny_cfg

    cfg = _tiny_cfg()
    v = jax.device_get(CTCAttentionModel(cfg).init(
        jax.random.key(0), np.zeros((1, 16, cfg.input_dim), np.float32),
        np.zeros((1, 3), np.int32), np.asarray([3], np.int32)))
    return v["params"], v["batch_stats"], cfg


# ----------------------------------------------------------- the refusals

def _linked_copy(tmp_path: Path, real: str) -> Path:
    """The committed `best` as symlinks, with `real` a copy to damage."""
    dst = tmp_path / "best"
    shutil.copytree(CKPT / "best", dst, copy_function=os.symlink)
    (dst / real).unlink()
    shutil.copyfile(CKPT / "best" / real, dst / real)
    return dst / real


NODE = "d/1dcd939bdc643ea60361c0e54938793e"
DATA = "ocdbt.process_0/d/fff6ca5bf2951e10272a4dcbe7f645ef"


@pytest.mark.parametrize("damage,file,message", [
    ("flip", "manifest.ocdbt", "CRC32C mismatch"),
    ("flip", NODE, "CRC32C mismatch"),
    ("truncate", "manifest.ocdbt", r"the header gives 116 bytes, the file "
                                   r"has 100 \(truncated\?\)"),
    ("truncate", NODE, r"of 2553 bytes at offset 0 \(truncated\?\)"),
    ("truncate", DATA, r"\(truncated\?\)"),
    ("magic", NODE, "magic 0x0cdb3a2a, expected 0x0cdb20de"),
    ("delete", DATA, "missing file"),
], ids=["flipped_manifest", "flipped_node", "truncated_manifest",
        "truncated_node", "truncated_data", "wrong_magic", "missing_data"])
def test_damaged_checkpoint_raises(tmp_path, damage, file, message):
    path = _linked_copy(tmp_path, file)
    data = bytearray(path.read_bytes())
    if damage == "flip":
        data[20] ^= 0x01
    elif damage == "truncate":
        data = data[:100 if file == "manifest.ocdbt" else len(data) // 2]
    elif damage == "magic":
        data[:4] = (0x0CDB3A2A).to_bytes(4, "big")
    if damage == "delete":
        path.unlink()
    else:
        path.write_bytes(bytes(data))
    with pytest.raises(OrbaxFormatError, match=message):
        read_orbax_checkpoint(str(tmp_path / "best"))


def test_missing_libzstd_raises_naming_it(monkeypatch):
    monkeypatch.setattr(orbax_format, "LIBZSTD", "libzstd-absent.so.9")
    with pytest.raises(OSError, match="zstd library libzstd-absent.so.9"):
        read_orbax_checkpoint(str(CKPT / "best"))


def test_missing_chunk_raises(tmp_path):
    t = ts.open(_zarr_spec(tmp_path, "a", [6], [2], "<f4", "zstd"),
                create=True).result()
    t.write(np.arange(6, dtype=np.float32)).result()
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{tmp_path}/"}).result()
    kv.delete_range(ts.KvStore.KeyRange("a/1", "a/2")).result()
    with pytest.raises(OrbaxFormatError, match="missing chunk a/1"):
        read_zarr_array(OcdbtStore(str(tmp_path)), "a")


@pytest.mark.parametrize("field,spec", [
    ("compressor", dict(dtype="<f4", compressor={
        "id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1})),
    ("dtype", dict(dtype="<f8", compressor="zstd")),
    ("order", dict(dtype="<f4", compressor=None, order="F")),
])
def test_unsupported_zarr_field_raises_naming_it(tmp_path, field, spec):
    s = _zarr_spec(tmp_path, "a", [4, 3], [2, 2], spec["dtype"],
                   spec["compressor"])
    if "order" in spec:
        s["metadata"]["order"] = spec["order"]
    t = ts.open(s, create=True).result()
    t.write(np.ones((4, 3), t.dtype.numpy_dtype)).result()
    with pytest.raises(OrbaxFormatError, match=rf"\.zarray: {field} "):
        read_zarr_array(OcdbtStore(str(tmp_path)), "a")


def test_zstd_frame_without_its_size_grows_the_buffer():
    import zstandard

    data = np.repeat(np.random.default_rng(5).integers(
        0, 256, 300, dtype=np.uint8), 1000).tobytes()
    frame = zstandard.ZstdCompressor(write_content_size=False).compress(data)
    assert orbax_format.zstd_decompress(frame).tobytes() == data
    with pytest.raises(OrbaxFormatError, match="zstd: Destination buffer"):
        orbax_format.zstd_decompress(frame, limit=1 << 17)
    with pytest.raises(OrbaxFormatError, match="expected 300001"):
        orbax_format.zstd_decompress(frame, size=300_001)


def test_crc32c_known_answers():
    assert orbax_format.crc32c(b"123456789") == 0xE3069283
    assert orbax_format.crc32c(b"") == 0
    assert orbax_format.crc32c(bytes(32)) == 0x8A9136AA


# ---------------------------------- evaluate and serve from the orbax files

N_EVAL = 16


@pytest.fixture(scope="module")
def syn_split(tmp_path_factory):
    """The first 16 utterances of the syn_full test split (the corpus the
    checkpoint was trained on: easy profile, 16-40 phones, 41 units) and
    the shipped recipe's YAML pointing at them."""
    from mdd_tpu_torch.tools import synthetic_corpus

    root = tmp_path_factory.mktemp("syn_full")
    units = root / "units_41"
    units.write_text("\n".join(CANONICAL_UNITS_41) + "\n")
    synthetic_corpus.cli([str(root / "data"), "0", "0", str(N_EVAL),
                          "--min-phones", "16", "--max-phones", "40",
                          "--units", str(units)])
    text = (ROOT / "conf" / "synthetic_full.yaml").read_text().replace(
        "data/synthetic_full/", f"{root / 'data'}/")
    (root / "syn.yaml").write_text(text)
    return root


def _report(text: str) -> dict:
    grab = lambda key: int(re.search(rf"{key} :  (\d+)", text).group(1))
    return {k: grab(k) for k in ("TA", "FR", "FA", "TR")}


def test_evaluate_from_orbax_matches_mdd_tpu(syn_split, orbax_best, capsys):
    conf = str(syn_split / "syn.yaml")
    dump = syn_split / "port_dump"
    assert cli.main(["evaluate", "--conf", conf, "--checkpoint",
                     str(CKPT / "best"), "--device", "cpu",
                     "--dump-dir", str(dump)]) == 0
    ours = capsys.readouterr().out

    cfg = jax_load_config(conf)
    vocab = JaxVocab.from_units_file(cfg.vocab_file)
    state, meta = orbax_best
    session = JaxEvalSession(
        dataclasses.replace(_model_config_from_meta(meta),
                            use_pallas_lstm=False),
        {"params": state["params"], "batch_stats": state["batch_stats"]},
        vocab, decode_type=cfg.decode_type, beam_width=cfg.beam_width,
        device_frontend=cfg.device_frontend)
    loader = jax_build_loader(cfg, vocab, cfg.test_scp_path,
                              cfg.test_lab_path, cfg.test_trans_path,
                              train=False, device_fe=cfg.device_frontend,
                              mesh=session.mesh, allow_cache=False)
    lines = []
    jax_evaluate_model(session, loader, dump_dir=str(syn_split / "jax_dump"),
                       log=lambda *a: lines.append(" ".join(map(str, a))))
    theirs = "\n".join(lines)
    assert f"time used for decode {N_EVAL} sentences" in ours
    assert _report(ours) == _report(theirs)
    assert sum(_report(ours).values()) > 300
    for name in ("decode_seq.log", "human_seq.log", "transcribe.log"):
        assert ((dump / name).read_text()
                == (syn_split / "jax_dump" / name).read_text()), name


def test_serve_from_orbax_answers_as_from_the_pt(tmp_path, monkeypatch,
                                                 capsys):
    from mdd_tpu_torch.frontend.cmvn import CmvnStats, write_kaldi_cmvn_text
    from mdd_tpu_torch.frontend.pipeline import BatchedFbank
    from mdd_tpu_torch.frontend.wav import read_audio, write_wav
    from test_torch_lexicon import write_dictionary

    rng = np.random.default_rng(6)
    paths = []
    for i, secs in enumerate((0.8, 1.5, 2.4)):
        n = int(secs * 16000)
        sig = (3000 * np.sin(2 * np.pi * (250 + 170 * i) * np.arange(n)
                             / 16000) + 600 * rng.standard_normal(n))
        paths.append(str(tmp_path / f"w{i}.wav"))
        write_wav(paths[-1], sig.astype(np.float32), 16000)
    feats = BatchedFbank(device="cpu")([read_audio(p)[0] for p in paths])
    write_kaldi_cmvn_text(CmvnStats.accumulate(feats),
                          str(tmp_path / "cmvn.txt"))
    (tmp_path / "units").write_text("\n".join(CANONICAL_UNITS_41) + "\n")
    (tmp_path / "serve.yaml").write_text(
        f"vocab_file: {tmp_path / 'units'}\ndecode_type: Beam\n")
    state, meta = load_checkpoint(str(CKPT), "best")
    save_checkpoint(str(tmp_path / "pt"), "best", state, meta)
    dict_dir, _ = write_dictionary(tmp_path / "dict")
    canon = [["sil", "b", "aa", "t", "sil"], ["k", "ae", "t", "s"],
             ["s", "iy", "m", "d", "ow"]]
    lines = "".join(json.dumps({"id": i, "wav": p, "word": f"w{i}",
                                "canonical": c}) + "\n"
                    for i, (p, c) in enumerate(zip(paths, canon)))

    def serve(checkpoint):
        monkeypatch.setattr("sys.stdin", io.StringIO(lines))
        assert cli.main(["serve", "--conf", str(tmp_path / "serve.yaml"),
                         "--cmvn", str(tmp_path / "cmvn.txt"),
                         "--checkpoint", checkpoint, "--dict-dir", dict_dir,
                         "--no-denoise", "--device", "cpu", "--quiet"]) == 0
        return [json.loads(l) for l in capsys.readouterr().out.splitlines()]

    timing = ("seconds", "amortized_seconds")
    from_orbax, from_pt = ([{k: v for k, v in r.items() if k not in timing}
                            for r in serve(checkpoint)]
                           for checkpoint in (str(CKPT / "best"),
                                              str(tmp_path / "pt")))
    assert [r["status"] for r in from_orbax] == ["ok"] * 3
    assert from_orbax == from_pt
