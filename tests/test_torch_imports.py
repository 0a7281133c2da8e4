"""The port stands alone: no module of mdd_tpu_torch, and not chip_smoke.py,
imports JAX, flax, orbax or anything of mdd_tpu (checked on the AST, so
an import inside a function counts too), and no file of mdd_tpu_torch
names the repository's C++ directory `native/`: the port builds its host
libraries from its own copies in `mdd_tpu_torch/csrc/`."""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mdd_tpu"}
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
