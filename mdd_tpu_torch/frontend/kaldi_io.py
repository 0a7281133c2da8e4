"""Minimal Kaldi ark/scp matrix IO (counterpart of mdd_tpu/frontend/kaldi_io.py).

Binary float/double matrices ("BFM "/"BDM ", as `copy-feats
--compress=false` writes them) and vectors, scp indirection
(`utt path:offset`), the bulk reader of the device-resident corpus
(`bulk_load`) and the length scan (`matrix_rows`), and the writer the
feature and corpus tools use.  The bulk paths index each ark file once
through the native mmap reader (`native.NativeArkReader`, `csrc/ark_io.cc`);
an ark it cannot index (an entry that is not a float32 matrix) is read by
one sequential Python pass, as in mdd_tpu, but a library that fails to
build raises.  `bulk_load_python` is that pass for every file, the plain
version the native path is held against.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np


def read_scp(path: str) -> Dict[str, str]:
    """scp file -> {utt: rxspecifier} preserving order."""
    out: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            utt, rx = line.split(" ", 1)
            out[utt] = rx
    return out


def _read_token(f) -> str:
    tok = b""
    while True:
        c = f.read(1)
        if c in (b" ", b""):
            break
        tok += c
    return tok.decode()


def _expect(f, byte: bytes) -> None:
    got = f.read(1)
    if got != byte:
        raise ValueError(f"malformed Kaldi binary header: {got!r} where "
                         f"{byte!r} was expected")


def _read_binary_matrix(f) -> np.ndarray:
    token = _read_token(f)
    if token in ("BFM", "BDM"):
        dtype = np.float32 if token == "BFM" else np.float64
        _expect(f, b"\x04")
        rows = struct.unpack("<i", f.read(4))[0]
        _expect(f, b"\x04")
        cols = struct.unpack("<i", f.read(4))[0]
        data = np.frombuffer(f.read(rows * cols * dtype().itemsize),
                             dtype=dtype)
        return data.reshape(rows, cols).astype(np.float32)
    if token in ("BFV", "BDV"):
        dtype = np.float32 if token == "BFV" else np.float64
        _expect(f, b"\x04")
        n = struct.unpack("<i", f.read(4))[0]
        return np.frombuffer(f.read(n * dtype().itemsize),
                             dtype=dtype).astype(np.float32)
    raise ValueError(f"unsupported Kaldi binary token {token!r} "
                     "(compressed matrices are not supported)")


def _split_rx(rxspecifier: str):
    """`path:offset` -> (path, offset); a plain path -> (path, None)."""
    if ":" in rxspecifier and rxspecifier.rsplit(":", 1)[1].isdigit():
        path, offset = rxspecifier.rsplit(":", 1)
        return path, int(offset)
    return rxspecifier, None


def load_mat(rxspecifier: str) -> np.ndarray:
    """Load one matrix given `path:offset` (scp entry) or a plain path."""
    path, offset = _split_rx(rxspecifier)
    with open(path, "rb") as f:
        if offset is not None:
            f.seek(offset)
        else:
            _read_token(f)  # skip utt id when reading a bare ark
        if f.read(2) != b"\x00B":
            raise ValueError("only binary Kaldi matrices are supported")
        return _read_binary_matrix(f)


def read_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (utt, matrix) over a binary ark file."""
    with open(path, "rb") as f:
        while True:
            utt = _read_token(f)
            if not utt:
                return
            if f.read(2) != b"\x00B":
                raise ValueError("only binary arks are supported")
            yield utt, _read_binary_matrix(f)


def _iter_ark_with_offsets(path: str) -> Iterator[Tuple[str, int, np.ndarray]]:
    """Like read_ark, also yielding each entry's '\\0B' marker offset (the
    offset scp entries point at)."""
    with open(path, "rb") as f:
        while True:
            utt = _read_token(f)
            if not utt:
                return
            offset = f.tell()
            if f.read(2) != b"\x00B":
                raise ValueError("only binary arks are supported")
            yield utt, offset, _read_binary_matrix(f)


def _group_by_ark(rxspecifiers: Iterable[str]):
    """-> (number of entries, {ark path: [(input index, offset or None)]})."""
    groups: Dict[str, List[Tuple[int, Optional[int]]]] = {}
    n = 0
    for k, rx in enumerate(rxspecifiers):
        path, off = _split_rx(rx)
        groups.setdefault(path, []).append((k, off))
        n = k + 1
    return n, groups


def _load_group_python(path: str, entries, out: list) -> None:
    """One sequential pass over `path` fills out[k] for its entries."""
    by_off: Dict[int, np.ndarray] = {}
    first = None
    for _, off, mat in _iter_ark_with_offsets(path):
        if first is None:
            first = mat
        by_off[off] = mat
    for k, off in entries:
        if off is None:
            out[k] = first
        else:
            mat = by_off.get(off)
            out[k] = mat if mat is not None else load_mat(f"{path}:{off}")


def bulk_load(rxspecifiers: Iterable[str]) -> List[np.ndarray]:
    """Load many scp entries, indexing each ark file once, instead of one
    open and seek an entry; -> matrices in the input order.

    Each file goes through the native mmap reader; one it cannot index
    (not plain BFM) through one sequential Python pass.  An offset the
    index did not meet (a stale scp) falls back to load_mat, which raises
    if the entry is truly unreadable; a bare ark path stands for its first
    matrix, as in load_mat."""
    from mdd_tpu_torch.native import NativeArkReader

    n, groups = _group_by_ark(rxspecifiers)
    out: List[Optional[np.ndarray]] = [None] * n
    for path, entries in groups.items():
        try:
            reader = NativeArkReader(path)
        except OSError:
            _load_group_python(path, entries, out)
            continue
        with reader:
            for k, off in entries:
                i = 0 if off is None else reader.by_offset.get(off)
                out[k] = (reader.read(i) if i is not None
                          else load_mat(f"{path}:{off}"))
    return out


def bulk_load_python(rxspecifiers: Iterable[str]) -> List[np.ndarray]:
    """bulk_load by one sequential Python pass a file, for every file."""
    n, groups = _group_by_ark(rxspecifiers)
    out: List[Optional[np.ndarray]] = [None] * n
    for path, entries in groups.items():
        _load_group_python(path, entries, out)
    return out


def _iter_ark_headers(path: str) -> Iterator[Tuple[str, int, int, int]]:
    """Header-only ark scan: (utt, marker offset, rows, cols) an entry,
    seeking over the payloads."""
    with open(path, "rb") as f:
        while True:
            utt = _read_token(f)
            if not utt:
                return
            offset = f.tell()
            if f.read(2) != b"\x00B":
                raise ValueError("only binary arks are supported")
            token = _read_token(f)
            if token not in ("BFM", "BDM"):
                raise ValueError(f"unsupported token {token!r}")
            itemsize = 4 if token == "BFM" else 8
            _expect(f, b"\x04")
            rows = struct.unpack("<i", f.read(4))[0]
            _expect(f, b"\x04")
            cols = struct.unpack("<i", f.read(4))[0]
            f.seek(rows * cols * itemsize, 1)
            yield utt, offset, rows, cols


def matrix_rows(rxspecifiers: Iterable[str]) -> List[int]:
    """Row counts (frame lengths) of many scp entries without reading
    their payloads: the native index, or header-only seeks for a file it
    cannot index; input order kept."""
    from mdd_tpu_torch.native import NativeArkReader

    n, groups = _group_by_ark(rxspecifiers)
    out = [0] * n
    for path, entries in groups.items():
        try:
            reader = NativeArkReader(path)
        except OSError:
            by_off: Dict[int, int] = {}
            first = None
            for _, off, rows, _ in _iter_ark_headers(path):
                if first is None:
                    first = rows
                by_off[off] = rows
            for k, off in entries:
                if off is None:
                    out[k] = first
                else:
                    r = by_off.get(off)
                    out[k] = (r if r is not None
                              else load_mat(f"{path}:{off}").shape[0])
            continue
        with reader:
            for k, off in entries:
                i = 0 if off is None else reader.by_offset.get(off)
                out[k] = (int(reader.rows[i]) if i is not None
                          else load_mat(f"{path}:{off}").shape[0])
    return out


class ArkScpWriter:
    """Write (utt, matrix) pairs to a binary ark + scp pair."""

    def __init__(self, ark_path: str, scp_path: str | None = None):
        self.ark_path = ark_path
        self._ark = open(ark_path, "wb")
        self._scp = (open(scp_path, "w", encoding="utf-8")
                     if scp_path else None)

    def write(self, utt: str, mat: np.ndarray) -> None:
        mat = np.ascontiguousarray(mat, dtype=np.float32)
        self._ark.write(utt.encode() + b" ")
        offset = self._ark.tell()
        self._ark.write(b"\x00B" + b"BFM \x04"
                        + struct.pack("<i", mat.shape[0]) + b"\x04"
                        + struct.pack("<i", mat.shape[1]))
        self._ark.write(mat.tobytes())
        if self._scp:
            self._scp.write(f"{utt} {self.ark_path}:{offset}\n")

    def close(self) -> None:
        self._ark.close()
        if self._scp:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
