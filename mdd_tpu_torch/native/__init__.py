"""ctypes bindings of the port's host C++ libraries (counterpart of
mdd_tpu/native/__init__.py).

`spectral_denoise` runs the spectral-subtraction denoiser of
`csrc/denoise.cc` (the demo's denoise stage, shaped to plug into
`InferenceEngine(denoiser=...)`); `NativeArkReader` indexes a binary
float32 ark once through an mmap (`csrc/ark_io.cc`) for the bulk reads of
`frontend/kaldi_io.bulk_load` and `matrix_rows`.  Both libraries are built
with `g++` at first use by `ops/build.py`.  Where mdd_tpu passes the
input through unchanged (no toolchain, a failed build, the denoiser's
non-zero return), this module raises: a missing compiler or a failed
compile raises RuntimeError from the build, a failed denoise
RuntimeError here.  `NativeArkReader` raises OSError for a file it cannot
index (missing, or not plain BFM), which its callers take as the sign to
read that file in Python.
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from typing import Optional

import numpy as np

from mdd_tpu_torch.ops import build

_lib: Optional[ctypes.CDLL] = None
_ark_lib: Optional[ctypes.CDLL] = None


def load_denoiser() -> ctypes.CDLL:
    """Build (on first use) and load the denoiser library."""
    global _lib
    if _lib is None:
        lib = build.load_host("libmdddenoise.so")
        lib.mdd_denoise_process.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        lib.mdd_denoise_process.restype = ctypes.c_int
        _lib = lib
    return _lib


def denoise_cli_path() -> str:
    """The `mdd_denoise in.wav out.wav [aggressiveness]` tool, built on
    first use."""
    return str(build.build_host("mdd_denoise"))


def spectral_denoise(data: np.ndarray, sample_rate: int = 16000,
                     aggressiveness: int = 4) -> np.ndarray:
    """Denoise a mono waveform -> float32 waveform of the same length.

    The signature is InferenceEngine's denoiser hook (waveform, sr) ->
    waveform; the library works at 16 kHz, as mdd_tpu's does, and
    `aggressiveness` (0-4) is the demo's `4`."""
    lib = load_denoiser()
    x = np.ascontiguousarray(data, dtype=np.float32)
    out = np.empty_like(x)
    rc = lib.mdd_denoise_process(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
        aggressiveness, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"mdd_denoise_process returned {rc}")
    return out


def _load_ark_lib() -> ctypes.CDLL:
    global _ark_lib
    if _ark_lib is None:
        lib = build.load_host("libmddarkio.so")
        lib.mdd_ark_open.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_int64)]
        lib.mdd_ark_open.restype = ctypes.c_void_p
        lib.mdd_ark_entries.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.mdd_ark_utts_size.argtypes = [ctypes.c_void_p]
        lib.mdd_ark_utts_size.restype = ctypes.c_int64
        lib.mdd_ark_utts.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mdd_ark_base.argtypes = [ctypes.c_void_p]
        lib.mdd_ark_base.restype = ctypes.c_void_p
        lib.mdd_ark_read.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_float)]
        lib.mdd_ark_close.argtypes = [ctypes.c_void_p]
        _ark_lib = lib
    return _ark_lib


class NativeArkReader:
    """Indexed zero-copy access to one binary (BFM) ark file.

    `by_offset` maps an scp rx offset (the '\\0B' marker position) to the
    entry index; `view(i)` returns a read-only float32 view into the
    mapping; `read(i)` returns an owned copy.  Construction raises OSError
    when the file cannot be indexed (missing, or an entry that is not a
    float32 matrix); a library that does not build raises RuntimeError."""

    def __init__(self, path: str):
        lib = _load_ark_lib()
        n = ctypes.c_int64(0)
        self._h = lib.mdd_ark_open(path.encode(), ctypes.byref(n))
        if not self._h:
            raise OSError(f"cannot index ark natively: {path}")
        self._lib = lib
        self.n = n.value
        marker = np.empty(self.n, np.int64)
        data_off = np.empty(self.n, np.int64)
        rows = np.empty(self.n, np.int32)
        cols = np.empty(self.n, np.int32)
        lib.mdd_ark_entries(
            self._h,
            marker.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            data_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        buf = ctypes.create_string_buffer(int(lib.mdd_ark_utts_size(self._h)))
        lib.mdd_ark_utts(self._h, buf)
        self.utts = buf.raw.decode().split("\n")[:-1]
        self.rows, self.cols = rows, cols
        self._data_off = data_off
        self.by_offset = {int(o): i for i, o in enumerate(marker)}
        base = lib.mdd_ark_base(self._h)
        total = (int(data_off[-1]) + int(rows[-1]) * int(cols[-1]) * 4
                 if self.n else 0)
        self._buf = (ctypes.c_char * total).from_address(base) \
            if total else b""
        self._live_views = 0       # outstanding zero-copy views
        self._close_deferred = False
        # finalizers run on whatever thread triggers the collection, so the
        # counter moves under a lock shared with view() and close()
        self._view_lock = threading.Lock()

    def view(self, i: int) -> np.ndarray:
        """Zero-copy (rows, cols) float32 view into the mapped file.

        The view keeps the mapping alive: close() defers the munmap until
        every outstanding view has been collected, so a view held past
        close() reads valid memory."""
        if not self._h:
            raise ValueError("reader is closed")
        r, c = int(self.rows[i]), int(self.cols[i])
        out = np.frombuffer(self._buf, np.float32, r * c,
                            int(self._data_off[i])).reshape(r, c)
        with self._view_lock:
            self._live_views += 1
        weakref.finalize(out, self._view_dropped)
        return out

    def _view_dropped(self) -> None:
        with self._view_lock:
            self._live_views -= 1
            do_close = self._close_deferred and self._live_views == 0
            if do_close:
                self._close_deferred = False
        if do_close:
            self.close()

    def read(self, i: int) -> np.ndarray:
        """Owned copy (no lifetime coupling to the mapping)."""
        r, c = int(self.rows[i]), int(self.cols[i])
        return np.frombuffer(self._buf, np.float32, r * c,
                             int(self._data_off[i])).reshape(r, c).copy()

    def close(self) -> None:
        if getattr(self, "_h", None):
            with self._view_lock:
                if self._live_views > 0:
                    # the last view's finalizer closes (close is idempotent)
                    self._close_deferred = True
                    return
            self._buf = b""
            self._lib.mdd_ark_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass
