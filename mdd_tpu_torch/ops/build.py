"""Build the package's CUDA and host C++ sources, loaded with ctypes.

Each `csrc/*.cu` file exports a plain C interface and is compiled by hand
with `nvcc` for `sm_90a` (Hopper) into `mdd_tpu_torch/_build/`, at first
use, keyed by a hash of the source, the shared `csrc/*.cuh` headers and
the flags, so an edited source or header is rebuilt.  The host sources
`csrc/denoise.cc` and `csrc/ark_io.cc` are compiled the same way with
`g++` and mdd_tpu's Makefile flags (`HOST_TARGETS`: the denoiser and the
ark reader as shared libraries, the `mdd_denoise` command line tool).
Nothing here runs at import time, and nothing falls back: a missing
compiler or a failed compile raises.  Each build is written under a
per-process name and moved into place, so processes building at once
never see a partial file.  `KernelBinding` binds one library's entry
point and counts its launches; extra flags (`-DMDD_LSTM_FWD_STAMPS`)
build a separate library beside the normal one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

from mdd_tpu_torch.utils import trace

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# mdd_tpu's Makefile flags for its C++ libraries: CXXFLAGS, then each
# target's own
GXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall")
HOST_TARGETS = {
    "libmdddenoise.so": ("denoise.cc", ("-shared",)),
    "libmddarkio.so": ("ark_io.cc", ("-shared",)),
    "mdd_denoise": ("denoise.cc", ("-DMDD_DENOISE_MAIN",)),
}

_loaded: Dict[tuple, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of mdd_tpu_torch are built from source on first use")


def library_path(source: str, extra: tuple = ()) -> Path:
    """Where `csrc/<source>` builds to with NVCC_FLAGS + `extra` (the name
    carries a hash of the source, the shared headers and the flags).  An
    absolute `source` names a file outside `csrc/` (a variant under
    trial); it includes the headers of `csrc/` all the same."""
    src = CSRC / source
    text = src.read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS + extra).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def _tmp_path(out: Path) -> Path:
    # per-process name: two processes building at once never share a file
    return out.with_name(f"{out.name}.{os.getpid()}.tmp")


def gxx_path() -> str:
    cand = os.environ.get("CXX") or shutil.which("g++")
    if not cand or not shutil.which(cand):
        raise RuntimeError("g++ not found (set CXX): the host libraries of "
                           "mdd_tpu_torch are built from source on first use")
    return cand


def host_path(target: str) -> Path:
    """Where the host target `target` (a key of HOST_TARGETS) builds to;
    the name carries a hash of its source and flags."""
    source, extra = HOST_TARGETS[target]
    flags = GXX_FLAGS + extra
    digest = hashlib.sha256((CSRC / source).read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    stem, dot, suffix = target.partition(".")
    return BUILD_DIR / f"{stem}-{digest}{dot}{suffix}"


def start_host_build(target: str) -> subprocess.Popen | None:
    """Start `g++` for one host target in the background (None if built)."""
    out = host_path(target)
    if out.exists():
        return None
    source, extra = HOST_TARGETS[target]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [gxx_path(), *GXX_FLAGS, *extra, "-o", str(_tmp_path(out)),
           str(CSRC / source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish_host_build(target: str, proc: subprocess.Popen | None) -> Path:
    """Wait for `start_host_build`'s compile; returns the built file."""
    out = host_path(target)
    if proc is not None:
        with trace.span("kernel.build"):
            log, _ = proc.communicate()
        if proc.returncode != 0:
            _tmp_path(out).unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {target}:\n{log}")
        os.replace(_tmp_path(out), out)
    return out


def build_host(target: str) -> Path:
    return finish_host_build(target, start_host_build(target))


def load_host(target: str) -> ctypes.CDLL:
    """Build (if needed) and load a host shared library; cached per
    process."""
    lib = _loaded.get(("host", target))
    if lib is None:
        lib = ctypes.CDLL(str(build_host(target)))
        _loaded[("host", target)] = lib
    return lib


def start_build(source: str, extra: tuple = ()) -> subprocess.Popen | None:
    """Start `nvcc` for one source in the background (None if built).

    `finish_build` waits for it; starting every source first lets the
    compiles run in parallel."""
    out = library_path(source, extra)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-I", str(CSRC), "-o",
           str(_tmp_path(out)), str(CSRC / source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish_build(source: str, proc: subprocess.Popen | None,
                 extra: tuple = ()) -> str:
    """Wait for `start_build`'s compile; returns nvcc's output (the
    `-Xptxas -v` register and shared-memory report)."""
    out = library_path(source, extra)
    if proc is None:
        return ""
    with trace.span("kernel.build"):
        log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    os.replace(_tmp_path(out), out)
    out.with_suffix(".log").write_text(log)
    return log


def build(source: str, extra: tuple = ()) -> str:
    return finish_build(source, start_build(source, extra), extra)


def load(source: str, extra: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<source>` with NVCC_FLAGS +
    `extra`; cached per process."""
    lib = _loaded.get((source, extra))
    if lib is None:
        build(source, extra)
        lib = ctypes.CDLL(str(library_path(source, extra)))
        _loaded[(source, extra)] = lib
    return lib


class KernelBinding:
    """ctypes binding of one `csrc/` library with a launch counter.

    `argtypes` are the entry point's arguments before the stream.
    `launches` counts the calls that launched the kernel (under a lock:
    two serving threads may launch at once); it is a plain integer that a
    caller may reset.  `extra_flags` are passed to nvcc
    after NVCC_FLAGS (a binding of the stamped build sets them)."""

    source = ""
    entry = ""
    argtypes: tuple = ()

    def __init__(self, extra_flags: tuple = ()):
        self.launches = 0
        self._count_lock = threading.Lock()
        self.extra_flags = tuple(extra_flags)
        self._lib = None

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = load(self.source, self.extra_flags)
            fn = getattr(lib, self.entry)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.mdd_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mdd_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def _launch(self, device, *args) -> None:
        lib = self.library()
        # The entry point launches on the runtime's current device and on
        # the current stream of `device`.  On an H100 host the device
        # context costs 6-9 us a call and torch.cuda.current_stream 8 us
        # (python -m mdd_tpu_torch.ops.dropout_time --host), so the context
        # is entered only when `device` is not current, and the stream is
        # read as its raw handle (~0.2 us).  A device without an index
        # (torch.device("cuda")) is the current one.
        current = torch.cuda.current_device()
        index = current if device.index is None else device.index
        if index != current:
            with torch.cuda.device(index):
                return self._launch(torch.device("cuda", index), *args)
        stream = torch._C._cuda_getCurrentRawStream(index)
        err = getattr(lib, self.entry)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.entry} launch failed: "
                               + lib.mdd_cuda_error_string(err).decode())
        with self._count_lock:
            self.launches += 1
