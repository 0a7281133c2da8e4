"""The port stands alone: no module of mdd_tpu_torch, and not chip_smoke.py,
imports JAX, flax, orbax, anything of mdd_tpu or the repo-root bench.py
and tools/ (checked on the AST, so an import inside a function counts
too), and no file of mdd_tpu_torch names the repository's C++ directory
`native/`: the port builds its host libraries from its own copies in
`mdd_tpu_torch/csrc/`.  And nothing of mdd_tpu is left to port: every
module, CLI subcommand and public name has its counterpart, apart from
the JAX-only names listed with their reasons."""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
# `bench` and `tools` are the repo-root bench.py and tools/ (the port's
# own tools are mdd_tpu_torch.tools)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mdd_tpu", "bench",
             "tools"}
SOURCES = sorted((ROOT / "mdd_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_mdd_tpu_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_package_module_is_checked():
    assert len(SOURCES) > 20
    assert all(p.exists() for p in SOURCES)


@pytest.mark.parametrize("module", [
    "ops/dropout_cuda.py", "decode/arpa.py", "decode/lm_train.py",
    "decode/beam.py", "decode/beam_jit.py", "evals/wer.py",
    "evals/analysis.py", "evals/evaluate.py", "align/levenshtein.py",
    "align/mdd.py", "cli.py"])
def test_evaluation_slice_modules_are_checked(module):
    """The modules of the train-with-fused-dropout -> evaluate path exist
    and are among the checked sources; none imports `triton` or builds a
    kernel at import time (the sandbox's CPU tests import every module)."""
    path = ROOT / "mdd_tpu_torch" / module
    assert path in SOURCES
    top_level = {alias.name.split(".")[0]
                 for node in ast.parse(path.read_text()).body
                 if isinstance(node, ast.Import) for alias in node.names}
    assert "triton" not in top_level


@pytest.mark.parametrize("module", [
    "lexicon/__init__.py", "lexicon/phones.py", "lexicon/timit.py",
    "lexicon/dictionary.py", "data/textgrid.py", "data/prepare.py",
    "infer.py", "serve.py"])
def test_lexicon_slice_modules_are_checked(module):
    """The modules of the lexicon and inference slice exist and are among
    the checked sources; the lexicon's optional backends (g2p_en,
    phonemizer, melo) are imported inside the functions that use them,
    never at module level, so the port imports on a machine without them."""
    path = ROOT / "mdd_tpu_torch" / module
    assert path in SOURCES
    top_level = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            top_level |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top_level.add(node.module.split(".")[0])
    assert not top_level & {"triton", "g2p_en", "phonemizer", "melo"}


@pytest.mark.parametrize("module", [
    "native/__init__.py", "frontend/mfcc.py", "frontend/spectrogram.py",
    "frontend/pipeline.py", "frontend/kaldi_io.py", "frontend/fbank.py",
    "ops/build.py", "serve.py", "tools/serve_loadtest.py"])
def test_front_end_slice_modules_are_checked(module):
    """The modules of the front-end and socket-serving slice exist, are
    among the checked sources, and import neither triton nor a built
    library at module level (the host libraries build at first use)."""
    path = ROOT / "mdd_tpu_torch" / module
    assert path in SOURCES
    top_level = {alias.name.split(".")[0]
                 for node in ast.parse(path.read_text()).body
                 if isinstance(node, ast.Import) for alias in node.names}
    assert "triton" not in top_level


# `native/` or "native" as a path part, but not the port's own
# `mdd_tpu_torch/native` nor mdd_tpu's `mdd_tpu/native` module path
_ROOT_NATIVE = re.compile(r"(?<![\w/.])native/|[\"']native[\"']")
PORT_FILES = sorted(p for p in (ROOT / "mdd_tpu_torch").rglob("*")
                    if p.suffix in {".py", ".cc", ".cu", ".cuh"})


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_does_not_name_the_native_directory(path):
    hits = [line for line in path.read_text().splitlines()
            if _ROOT_NATIVE.search(line)]
    assert not hits, f"{path.relative_to(ROOT)} names native/: {hits}"


def test_native_pattern_catches_the_root_directory():
    assert _ROOT_NATIVE.search('path = ROOT / "native" / "denoise.cc"')
    assert _ROOT_NATIVE.search("built from native/denoise.cc")
    assert not _ROOT_NATIVE.search("mdd_tpu_torch/native/__init__.py")
    assert not _ROOT_NATIVE.search("counterpart of mdd_tpu/native/x.py")
    assert (ROOT / "mdd_tpu_torch" / "csrc" / "denoise.cc") in PORT_FILES


@pytest.mark.parametrize("module", [
    "parallel/__init__.py", "parallel/mesh.py", "data/prefetch.py",
    "data/dataset.py", "data/device_cache.py", "models/ctc_model.py",
    "train/loop.py", "evals/evaluate.py", "cli.py",
    "tools/distributed_smoke.py"])
def test_scale_out_slice_modules_are_checked(module):
    """The modules of the scale-out slice exist and are among the checked
    sources, import no triton at module level, and importing one joins
    no process group (only `init_distributed`, called by an entry point,
    does)."""
    import importlib

    import torch.distributed as dist

    path = ROOT / "mdd_tpu_torch" / module
    assert path in SOURCES
    top_level = {alias.name.split(".")[0]
                 for node in ast.parse(path.read_text()).body
                 if isinstance(node, ast.Import) for alias in node.names}
    assert "triton" not in top_level
    name = "mdd_tpu_torch." + module[:-3].replace("/", ".").replace(
        ".__init__", "")
    importlib.import_module(name)
    assert not dist.is_initialized()


@pytest.mark.parametrize("module", [
    "utils/precision.py", "utils/visualize.py", "train/loop.py",
    "train/checkpoint.py", "evals/evaluate.py"])
def test_last_slice_modules_are_checked(module):
    """The modules of the last slice (the float32 rule, the plateau
    snapshots in `latest`, the visualizer) exist and are among the checked
    sources; none imports triton or matplotlib at module level, so the
    port imports on a machine without them (the card's has no
    matplotlib)."""
    path = ROOT / "mdd_tpu_torch" / module
    assert path in SOURCES
    top_level = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            top_level |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top_level.add(node.module.split(".")[0])
    assert not top_level & {"triton", "matplotlib"}


# mdd_tpu's Pallas kernels are the port's CUDA wrappers; every other
# module keeps its path
PALLAS_TO_CUDA = {"ops/lstm_pallas.py": "ops/lstm_cuda.py",
                  "ops/dropout_pallas.py": "ops/dropout_cuda.py"}
JAX_MODULES = sorted(p.relative_to(ROOT / "mdd_tpu").as_posix()
                     for p in (ROOT / "mdd_tpu").rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_mdd_tpu_module_has_its_port(module):
    """Nothing of mdd_tpu is left to port: each of its modules has its
    counterpart at the same path under mdd_tpu_torch/ (a module added to
    mdd_tpu later shows up here)."""
    port = ROOT / "mdd_tpu_torch" / PALLAS_TO_CUDA.get(module, module)
    assert port.exists(), f"mdd_tpu/{module} has no port"


def test_the_module_map_covers_the_pallas_files():
    assert len(JAX_MODULES) > 40
    assert set(PALLAS_TO_CUDA) <= set(JAX_MODULES)
    assert not [m for m in JAX_MODULES
                if "pallas" in m and m not in PALLAS_TO_CUDA]


@pytest.mark.parametrize("module", [
    "bench.py", "cli.py", "decode/__init__.py", "decode/greedy.py",
    "data/vocab.py", "ops/ctc_loss.py", "train/loop.py"])
def test_benchmark_slice_modules_are_checked(module):
    """The modules of the benchmark slice (bench.py and the last public
    names) exist, are among the checked sources, import neither triton
    nor a repo-root module at module level, and importing one builds no
    kernel and joins no process group."""
    import importlib

    import torch.distributed as dist

    path = ROOT / "mdd_tpu_torch" / module
    assert path in SOURCES
    top_level = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            top_level |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top_level.add(node.module.split(".")[0])
    assert not top_level & {"triton", "bench", "tools"}
    name = "mdd_tpu_torch." + module[:-3].replace("/", ".").replace(
        ".__init__", "")
    importlib.import_module(name)
    assert not dist.is_initialized()


def _subcommands(parser) -> set:
    import argparse

    return {name for action in parser._actions
            if isinstance(action, argparse._SubParsersAction)
            for name in action.choices}


def test_every_mdd_tpu_subcommand_has_its_port():
    from mdd_tpu.cli import build_parser as jax_parser
    from mdd_tpu_torch.cli import build_parser

    theirs, ours = _subcommands(jax_parser()), _subcommands(build_parser())
    assert len(theirs) == 12 and "benchmark" in theirs
    assert theirs <= ours


# mdd_tpu's public names with no port of the same name: JAX-only by
# nature, each with the port's design in its place
JAX_ONLY = {
    "data/device_cache.py": {
        "make_cache_assemble": "a jitted batch assembly; the port gathers "
                               "in DeviceFeatureCache.gather on the device",
    },
    "frontend/augment.py": {
        "spec_augment_jax": "jax.random masks; the port masks on the "
                            "device from host geometry "
                            "(apply_spec_augment_masks)",
    },
    "native/__init__.py": {
        "ensure_built": "silent pass-through when a build fails; the port "
                        "builds at first use and raises (ROADMAP §3)",
        "native_available": "the same pass-through's probe",
    },
    "parallel/mesh.py": {
        name: "a jax.sharding mesh helper; the port runs one process a "
              "rank over torch.distributed"
        for name in ("make_mesh", "make_local_mesh", "batch_sharding",
                     "replicated", "shard_batch")},
    "parallel/__init__.py": {
        name: "re-export of the mesh helper of the same name"
        for name in ("make_mesh", "batch_sharding", "replicated",
                     "shard_batch")},
    "train/loop.py": {
        "TrainState": "flax's train state; the port's Trainer holds the "
                      "model and the torch optimizer",
    },
    "train/__init__.py": {
        "TrainState": "re-export of train/loop.py's TrainState",
    },
}
# a name a package of the port does not re-export, and why
NOT_REEXPORTED = {
    "ops/__init__.py": {
        "ctc_loss": "the re-export would hide the module ops.ctc_loss "
                    "(`from mdd_tpu_torch.ops import ctc_loss` is the "
                    "module); the function is ops.ctc_loss.ctc_loss",
    },
}
# a Pallas wrapper's name in its CUDA counterpart
RENAMED = {"ops/lstm_pallas.py": {"bilstm_pallas": "bilstm_cuda"}}


def _public_names(path: pathlib.Path) -> set:
    """Top-level functions, classes (and their public methods) and
    assignments not starting with `_`; for a package's __init__ also the
    names it re-exports from its own package.  Other imports are not a
    module's API."""
    names = set()
    init = path.name == "__init__.py"
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            names |= {f"{node.name}.{sub.name}" for sub in node.body
                      if isinstance(sub, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif (init and isinstance(node, ast.ImportFrom) and node.level == 0
              and node.module.split(".")[0] in ("mdd_tpu", "mdd_tpu_torch")):
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.split(".")[-1].startswith("_")}


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_of_mdd_tpu_has_its_port(module):
    port = ROOT / "mdd_tpu_torch" / PALLAS_TO_CUDA.get(module, module)
    renamed = RENAMED.get(module, {})
    want = {renamed.get(n, n)
            for n in _public_names(ROOT / "mdd_tpu" / module)}
    missing = (want - _public_names(port) - set(JAX_ONLY.get(module, {}))
               - set(NOT_REEXPORTED.get(module, {})))
    assert not missing, f"mdd_tpu/{module}: no port of {sorted(missing)}"


def test_the_jax_only_list_names_real_gaps():
    """Every listed name is public in mdd_tpu and absent from the port,
    so the list shrinks when a name is ported; `ops.ctc_loss` stays a
    module."""
    import types

    from mdd_tpu_torch import ops

    assert isinstance(ops.ctc_loss, types.ModuleType)
    for module, names in {**JAX_ONLY, **NOT_REEXPORTED}.items():
        port = ROOT / "mdd_tpu_torch" / module
        assert set(names) <= _public_names(ROOT / "mdd_tpu" / module)
        assert not set(names) & _public_names(port), module
        assert all(reason for reason in names.values())
    for module, names in RENAMED.items():
        assert set(names) <= _public_names(ROOT / "mdd_tpu" / module)
        assert set(names.values()) <= _public_names(
            ROOT / "mdd_tpu_torch" / PALLAS_TO_CUDA[module])


# the card's machine has none of these; orbax and tensorstore appear in
# tests/test_torch_orbax.py only, as the reader's reference
ORBAX_READER_FORBIDDEN = {"jax", "orbax", "tensorstore", "zstandard",
                          "numcodecs", "ml_dtypes"}


@pytest.mark.parametrize("module", ["train/orbax_format.py",
                                    "train/checkpoint.py", "bench.py",
                                    "convert.py"])
def test_orbax_reader_needs_none_of_jax_orbax_or_a_codec_package(module):
    """The modules that read mdd_tpu's orbax checkpoints import none of
    jax, orbax, tensorstore, zstandard, numcodecs or ml_dtypes, anywhere
    in the file; the reader's own imports at module level are the
    standard library's and numpy."""
    path = ROOT / "mdd_tpu_torch" / module
    assert path in SOURCES
    assert not set(_imported_roots(path)) & ORBAX_READER_FORBIDDEN
    if module == "train/orbax_format.py":
        top = set()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Import):
                top |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                top.add(node.module.split(".")[0])
        assert top == {"__future__", "ctypes", "functools", "json", "os",
                       "shutil", "time", "typing", "numpy"}
