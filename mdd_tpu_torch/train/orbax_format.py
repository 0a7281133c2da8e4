"""mdd_tpu's orbax checkpoints, read and written without JAX, orbax or
tensorstore.

mdd_tpu saves `<directory>/<name>/` with orbax's StandardCheckpointer
(mdd_tpu/train/checkpoint.py) and restores it with the same class.
`load_mdd_tpu_checkpoint` is the port's counterpart of that restore: it
reads the files with numpy, and with the system's zstd library through
ctypes, and bridges them with convert.flax_to_torch.
`save_mdd_tpu_checkpoint` is the counterpart of the save: it bridges
back with convert.torch_to_flax (and torch_adam_to_optax for the
optimizer) and `write_orbax_checkpoint` writes the layout below, one
that orbax and this reader both read back bit for bit (not orbax's own
bytes: one OCDBT version, one b-tree leaf, one data file).  Everything
here runs on the host; the weights reach the card through
load_state_dict.

The format, layer by layer.  Each field was read from the bytes and held
against tensorstore's and orbax's own reads (tests/test_torch_orbax.py
repeats that on every run).

orbax.  `<dir>/_METADATA` is JSON with `use_ocdbt` (must be true) and
  `use_zarr3` (must be false).  Its `tree_metadata` maps each leaf, e.g.
  "('params', 'conv', 'conv0', 'kernel')", to `key_metadata`, one
  {"key", "key_type"} a level (key_type 2: a dict key, 1: a sequence
  index), and `value_metadata.value_type`: "np.ndarray" (what mdd_tpu's
  save_checkpoint writes) is an array stored under its keys joined by
  '.', and "None", "Dict" or "List" an empty node with nothing stored.
  The key-value store that holds the arrays is an OCDBT database rooted
  at `<dir>`.

OCDBT framing.  The manifest `<dir>/manifest.ocdbt` and every b-tree node
  are one frame each:
      magic        4 bytes, big endian: 0x0cdb3a2a manifest,
                   0x0cdb20de b-tree node
      length       8 bytes, little endian: the frame's size in bytes
      version      varint, 0
      compression  varint: 0 none, 1 zstd
      payload      one zstd frame when compressed
      crc32c       4 bytes, little endian: CRC32C (Castagnoli) of
                   every byte before it
  Integers in a payload are LEB128 varints unless said otherwise, and a
  list of records is stored column by column.

Data file table (manifest and nodes): n, then prefix_length[n-1] (bytes
  shared with the previous path), suffix_length[n], base_path_length[n],
  then the suffixes.  A path names a file relative to `<dir>`.  In a node
  it is relative to the base path of the file the node was read from
  (every store the tests write, orbax's merged one among them, has only
  nodes in base path "", so that rule is not held against tensorstore).

Manifest payload.
  config: uuid (16 bytes), manifest_kind (0 single; 1, numbered, is not
    read here), max_inline_value_bytes, max_decoded_node_bytes,
    version_tree_arity_log2 (1 byte), compression (0 none, or 1 zstd
    followed by its level as 4 bytes little endian);
  the data file table;
  versions: n, generation_number[n], root_height[n] (1 byte each), the
    root's location data_file_id[n], offset[n], length[n], its
    statistics num_keys[n], num_tree_bytes[n],
    num_indirect_value_bytes[n], commit_time[n] (8 bytes LE each);
  version tree nodes: m, generation_number[m], data_file_id[m],
    offset[m], length[m], num_generations[m], commit_time[m] (8 bytes LE
    each), height[m] (1 byte each).  They hold older versions only: the
    newest version is the last inline one.

B-tree node payload.  height (1 byte), the data file table, n entries,
  their keys prefix-compressed: prefix_length[n-1], suffix_length[n],
  on an interior node subtree_common_prefix_length[n], then the suffix
  bytes.
  leaf (height 0): value_length[n], value_kind[n] (1 byte: 0 inline,
    1 in a data file), data_file_id[k] and offset[k] of the k values in
    data files, then the inline values one after another.  A value in a
    data file is its raw bytes at (file, offset, length).
  interior: the child's location data_file_id[n], offset[n], length[n],
    then num_keys[n], num_tree_bytes[n], num_indirect_value_bytes[n].  A
    child's keys leave out the first subtree_common_prefix_length bytes of
    its entry's key, which extend the prefix the parent's keys left out.

zarr v2.  An array `<name>` is the JSON `<name>/.zarray` (zarr_format 2,
  shape, chunks, dtype, compressor zstd or null, filters null, order
  "C", dimension_separator ".") and its chunks `<name>/<i>.<j>...`
  ("0" for a 0-d array), each of the full chunk shape even where the
  array ends inside it.  orbax writes every chunk, so a missing one is an
  error.  The zstd frames of the chunks do not record their size: the
  buffer is sized from `.zarray`.

The writer's choices.  `_METADATA` and `_CHECKPOINT_METADATA` as orbax
  writes them (an empty node is value_type "None", "Dict" or "List" with
  skip_deserialize true; optax's EmptyState, a NamedTuple without fields,
  is "None" there too).  The manifest's config is orbax's
  (max_inline_value_bytes 1024, max_decoded_node_bytes 100,000,000,
  arity log2 4, zstd at level 0); the manifest and the one leaf node are
  zstd frames, the leaf holds every key, values of up to 1024 bytes
  inline and the rest in one data file `d/<32 hex digits>` that ends with
  the leaf.  Arrays are zarr v2 with `"compressor": {"id": "zstd",
  "level": 1}` and one chunk an array.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

LIBZSTD = "libzstd.so.1"

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE

_ZSTD_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_ZSTD_CONTENTSIZE_ERROR = (1 << 64) - 2
_ZSTD_ERROR_DST_SIZE_TOO_SMALL = 70     # zstd_errors.h

# zarr v2 dtype -> numpy dtype; "bfloat16" (orbax's name for it) is
# widened to float32, which holds every bfloat16 value exactly
_DTYPES = {"<f4": np.float32, "<f2": np.float16, "<i4": np.int32,
           "<i8": np.int64, "|u1": np.uint8, "|b1": np.bool_,
           "bfloat16": np.uint16}
_EMPTY_TYPES = {"None": None, "Dict": dict, "List": list}
# numpy dtype -> zarr v2 dtype, for the writer
_ZARR_DTYPES = {np.dtype(np.float32): "<f4", np.dtype(np.float16): "<f2",
                np.dtype(np.int32): "<i4", np.dtype(np.int64): "<i8",
                np.dtype(np.uint8): "|u1", np.dtype(np.bool_): "|b1"}

# the OCDBT config orbax writes: values of up to this many bytes sit in
# the leaf node, a node decodes to at most this many, zstd at level 0
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
NODE_ZSTD_LEVEL = 0
CHUNK_ZSTD_LEVEL = 1      # zarr's compressor, as orbax sets it
CHECKPOINT_HANDLER = ("orbax.checkpoint._src.handlers."
                      "standard_checkpoint_handler.StandardCheckpointHandler")


class OrbaxFormatError(ValueError):
    """A checkpoint that is damaged or uses a feature this reader lacks."""


# ------------------------------------------------------------------ zstd

@functools.lru_cache(maxsize=None)
def _libzstd(name: str) -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        raise OSError(
            f"reading an orbax checkpoint needs the system's zstd library "
            f"{name} (Debian / Ubuntu package libzstd1): {e}") from e
    size_t = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, size_t,
                                    ctypes.c_char_p, size_t]
    lib.ZSTD_decompress.restype = size_t
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p, size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_isError.argtypes = [size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_getErrorName.argtypes = [size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorCode.argtypes = [size_t]
    lib.ZSTD_getErrorCode.restype = ctypes.c_int
    lib.ZSTD_compressBound.argtypes = [size_t]
    lib.ZSTD_compressBound.restype = size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_void_p, size_t, ctypes.c_void_p,
                                  size_t, ctypes.c_int]
    lib.ZSTD_compress.restype = size_t
    return lib


def zstd_compress(data, level: int) -> bytes:
    """One zstd frame (with its content size) of the bytes of `data`, a
    bytes object or a C-contiguous numpy array."""
    lib = _libzstd(LIBZSTD)
    src = np.frombuffer(data, np.uint8) if isinstance(data, bytes) \
        else data.reshape(-1).view(np.uint8)
    out = np.empty(lib.ZSTD_compressBound(src.size), np.uint8)
    got = lib.ZSTD_compress(out.ctypes.data, out.size, src.ctypes.data,
                            src.size, level)
    if lib.ZSTD_isError(got):
        raise OrbaxFormatError(
            "zstd: " + lib.ZSTD_getErrorName(got).decode())
    return out[:got].tobytes()


def zstd_decompress(frame: bytes, size: Optional[int] = None,
                    limit: int = 1 << 34) -> np.ndarray:
    """The uint8 contents of zstd `frame`.

    `size` is the exact decompressed size where the caller knows it (a
    zarr chunk); otherwise it comes from the frame header, and where the
    header does not say, the buffer grows up to `limit` bytes."""
    lib = _libzstd(LIBZSTD)

    def call(capacity: int) -> Tuple[np.ndarray, int]:
        out = np.empty(capacity, np.uint8)
        got = lib.ZSTD_decompress(out.ctypes.data, capacity, frame,
                                  len(frame))
        return out, got

    def error(got: int) -> OrbaxFormatError:
        return OrbaxFormatError(
            "zstd: " + lib.ZSTD_getErrorName(got).decode())

    if size is None:
        n = lib.ZSTD_getFrameContentSize(frame, len(frame))
        if n == _ZSTD_CONTENTSIZE_ERROR:
            raise OrbaxFormatError("zstd: not a zstd frame")
        if n != _ZSTD_CONTENTSIZE_UNKNOWN:
            if n > limit:
                raise OrbaxFormatError(f"zstd: the frame holds {n} bytes, "
                                       f"over the limit of {limit}")
            size = n
    if size is not None:
        out, got = call(size)
        if lib.ZSTD_isError(got):
            raise error(got)
        if got != size:
            raise OrbaxFormatError(
                f"zstd: the frame holds {got} bytes, expected {size}")
        return out
    capacity = max(4 * len(frame), 1 << 16)
    while True:
        out, got = call(capacity)
        if not lib.ZSTD_isError(got):
            return out[:got]
        if (lib.ZSTD_getErrorCode(got) != _ZSTD_ERROR_DST_SIZE_TOO_SMALL
                or capacity >= limit):
            raise error(got)
        capacity = min(4 * capacity, limit)


# ---------------------------------------------------------------- crc32c

def _crc32c_table() -> Tuple[int, ...]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT and iSCSI use it."""
    crc = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ----------------------------------------------------------------- OCDBT

class _Reader:
    """A cursor over one decoded payload."""

    def __init__(self, data: bytes, what: str, pos: int = 0,
                 end: Optional[int] = None):
        self.data, self.what, self.pos = data, what, pos
        self.end = len(data) if end is None else end

    def _need(self, n: int) -> None:
        if self.pos + n > self.end:
            raise OrbaxFormatError(f"{self.what}: truncated payload")

    def varint(self) -> int:
        value = shift = 0
        while True:
            self._need(1)
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            shift += 7
            if byte < 0x80:
                return value
            if shift > 63:
                raise OrbaxFormatError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        self._need(n)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return bytes(out)

    def done(self) -> None:
        if self.pos != self.end:
            raise OrbaxFormatError(
                f"{self.what}: {self.end - self.pos} bytes left over")


def _unframe(data: bytes, magic: int, what: str,
             limit: int = 1 << 34) -> bytes:
    """Check an OCDBT frame's magic, length and CRC32C; -> its payload."""
    if len(data) < 18:
        raise OrbaxFormatError(f"{what}: truncated ({len(data)} bytes)")
    found = int.from_bytes(data[:4], "big")
    if found != magic:
        raise OrbaxFormatError(
            f"{what}: magic 0x{found:08x}, expected 0x{magic:08x}")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        raise OrbaxFormatError(
            f"{what}: the header gives {length} bytes, the file has "
            f"{len(data)} (truncated?)")
    stored = int.from_bytes(data[-4:], "little")
    if crc32c(data[:-4]) != stored:
        raise OrbaxFormatError(f"{what}: CRC32C mismatch")
    head = _Reader(data, what, 12, len(data) - 4)
    version = head.varint()
    if version != 0:
        raise OrbaxFormatError(f"{what}: format version {version}")
    method = head.varint()
    body = data[head.pos:-4]
    if method == 0:
        return body
    if method == 1:
        return zstd_decompress(body, limit=limit).tobytes()
    raise OrbaxFormatError(f"{what}: compression method {method}")


def _data_file_table(r: _Reader, base: str) -> List[Tuple[str, str]]:
    """-> [(base_path, path)] with `base` prepended to each."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base_len = r.varints(n)
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev) or base_len[i] > prefix[i] + suffix[i]:
            raise OrbaxFormatError(f"{r.what}: bad data file table")
        full = prev[:prefix[i]] + r.raw(suffix[i])
        prev = full
        text = full.decode("utf-8")
        out.append((base + text[:base_len[i]], base + text))
    return out


def _location(table, file_id: int, what: str) -> Tuple[str, str]:
    if file_id >= len(table):
        raise OrbaxFormatError(f"{what}: data file {file_id} of "
                               f"{len(table)}")
    return table[file_id]


class OcdbtStore:
    """The keys and values of the newest version of an OCDBT database.

    `get(key)` reads a value; `keys()` lists them in order."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        path = os.path.join(self.root, "manifest.ocdbt")
        r = _Reader(_unframe(self._read_file(path), MANIFEST_MAGIC, path),
                    path)
        r.raw(16)                                           # uuid
        kind = r.varint()
        if kind != 0:
            raise OrbaxFormatError(
                f"{path}: manifest_kind {kind} (only 0, single, is read)")
        r.varint()                                  # max_inline_value_bytes
        self.max_node_bytes = r.varint()
        r.raw(1)                                    # version_tree_arity_log2
        method = r.varint()
        if method == 1:
            r.raw(4)                            # zstd level, int32 LE
        elif method != 0:
            raise OrbaxFormatError(f"{path}: compression method {method}")
        table = _data_file_table(r, "")
        n = r.varint()
        r.varints(n)                                # generation_number
        heights = r.raw(n)
        files, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        num_keys = r.varints(n)
        r.varints(2 * n)                            # tree / indirect bytes
        r.raw(8 * n)                                # commit_time
        m = r.varint()
        r.varints(5 * m)            # generation, file, offset, length, count
        r.raw(8 * m)                                # commit_time
        r.raw(m)
        r.done()
        self._entries: Dict[bytes, Tuple[Optional[str], int, int,
                                         bytes]] = {}
        if n and num_keys[-1]:
            self._read_node(_location(table, files[-1], path), offsets[-1],
                            lengths[-1], heights[-1], b"")

    def _read_file(self, path: str, offset: int = 0,
                   length: Optional[int] = None) -> bytes:
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read() if length is None else f.read(length)
        except FileNotFoundError:
            raise OrbaxFormatError(f"missing file {path}") from None
        if length is not None and len(data) != length:
            raise OrbaxFormatError(
                f"{path}: {len(data)} of {length} bytes at offset {offset} "
                f"(truncated?)")
        return data

    def _file(self, rel: str) -> str:
        if os.path.isabs(rel) or ".." in rel.split("/"):
            raise OrbaxFormatError(f"data file path {rel!r} leaves the store")
        return os.path.join(self.root, rel)

    def _read_node(self, where: Tuple[str, str], offset: int, length: int,
                   height: int, prefix: bytes) -> None:
        base, rel = where
        path = self._file(rel)
        what = f"{path}@{offset}"
        r = _Reader(_unframe(self._read_file(path, offset, length),
                             NODE_MAGIC, what, self.max_node_bytes), what)
        if r.raw(1)[0] != height:
            raise OrbaxFormatError(f"{what}: height differs from its parent's")
        table = _data_file_table(r, base)
        n = r.varint()
        if n == 0:
            raise OrbaxFormatError(f"{what}: empty node")
        key_prefix = [0] + r.varints(n - 1)
        key_suffix = r.varints(n)
        common = r.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            if key_prefix[i] > len(prev):
                raise OrbaxFormatError(f"{what}: bad key prefix")
            prev = prev[:key_prefix[i]] + r.raw(key_suffix[i])
            keys.append(prev)
        if height:
            files, offsets, lengths = (r.varints(n), r.varints(n),
                                       r.varints(n))
            r.varints(3 * n)                        # statistics
            r.done()
            for i in range(n):
                if common[i] > len(keys[i]):
                    raise OrbaxFormatError(f"{what}: bad common prefix")
                self._read_node(_location(table, files[i], what), offsets[i],
                                lengths[i], height - 1,
                                prefix + keys[i][:common[i]])
            return
        value_len = r.varints(n)
        kinds = r.raw(n)
        if any(k > 1 for k in kinds):
            raise OrbaxFormatError(f"{what}: value kind {max(kinds)}")
        k = sum(kinds)
        files, offsets = r.varints(k), r.varints(k)
        indirect = iter(range(k))
        for key, size, kind in zip(keys, value_len, kinds):
            if kind:
                j = next(indirect)
                _, rel = _location(table, files[j], what)
                self._entries[prefix + key] = (rel, offsets[j], size, b"")
            else:
                self._entries[prefix + key] = (None, 0, size, r.raw(size))
        r.done()

    def keys(self) -> List[str]:
        return sorted(k.decode("utf-8") for k in self._entries)

    def __contains__(self, key: str) -> bool:
        return key.encode("utf-8") in self._entries

    def get(self, key: str) -> bytes:
        try:
            rel, offset, size, inline = self._entries[key.encode("utf-8")]
        except KeyError:
            raise OrbaxFormatError(f"{self.root}: no key {key!r}") from None
        if rel is None:
            return inline
        return self._read_file(self._file(rel), offset, size)


# ------------------------------------------------------------------ zarr

def _zarr_meta(store: OcdbtStore, name: str) -> dict:
    meta = json.loads(store.get(f"{name}/.zarray"))
    where = f"{store.root}: {name}/.zarray"
    expect = {"zarr_format": 2, "order": "C", "filters": None}
    for field, want in expect.items():
        if meta.get(field) != want:
            raise OrbaxFormatError(
                f"{where}: {field} {meta.get(field)!r} (supported: {want!r})")
    if meta.get("dimension_separator", ".") != ".":
        raise OrbaxFormatError(f"{where}: dimension_separator "
                               f"{meta['dimension_separator']!r}")
    if meta.get("dtype") not in _DTYPES:
        raise OrbaxFormatError(f"{where}: dtype {meta.get('dtype')!r} "
                               f"(supported: {sorted(_DTYPES)})")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OrbaxFormatError(f"{where}: compressor {compressor!r} "
                               f"(supported: zstd or null)")
    if len(meta["shape"]) != len(meta["chunks"]):
        raise OrbaxFormatError(f"{where}: shape and chunks differ in rank")
    return meta


def read_zarr_array(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array `name` of `store`, assembled from its chunks."""
    meta = _zarr_meta(store, name)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dtype = np.dtype(_DTYPES[meta["dtype"]])
    out = np.empty(shape, dtype)
    grid = [-(-s // c) if c else 0 for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for index in np.ndindex(*grid):
        key = f"{name}/{'.'.join(map(str, index)) if index else '0'}"
        if key not in store:
            raise OrbaxFormatError(f"{store.root}: missing chunk {key}")
        raw = store.get(key)
        if meta["compressor"] is not None:
            data = zstd_decompress(raw, size=chunk_bytes)
        else:
            if len(raw) != chunk_bytes:
                raise OrbaxFormatError(f"{store.root}: chunk {key} holds "
                                       f"{len(raw)} bytes, not {chunk_bytes}")
            data = np.frombuffer(raw, np.uint8)
        block = data.view(dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = block[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    if meta["dtype"] == "bfloat16":
        out = (out.astype(np.uint32) << 16).view(np.float32)
    return out


# ----------------------------------------------------------------- orbax

def read_orbax_checkpoint(path: str,
                          only: Optional[Tuple[str, ...]] = None
                          ) -> Dict[str, Any]:
    """The tree that orbax's StandardCheckpointer().restore(path) gives
    without a target: nested dicts (lists for sequences) of numpy arrays,
    bfloat16 widened to float32.  `only` names the top-level entries to
    read (all where None): a resumable checkpoint's `opt_state` is twice
    the size of its weights."""
    path = os.path.abspath(path)
    meta_path = os.path.join(path, "_METADATA")
    try:
        with open(meta_path, "r", encoding="utf-8") as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise OrbaxFormatError(f"missing file {meta_path}") from None
    for field, want in (("use_ocdbt", True), ("use_zarr3", False)):
        if meta.get(field) is not want:
            raise OrbaxFormatError(f"{meta_path}: {field} "
                                   f"{meta.get(field)!r} (supported: {want})")
    store = OcdbtStore(path)
    root: Dict[Any, Any] = {}
    sequences = set()
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        if only is not None and keys[0]["key"] not in only:
            continue
        value_type = entry["value_metadata"]["value_type"]
        node = root
        for depth, k in enumerate(keys):
            if k["key_type"] not in (1, 2):
                raise OrbaxFormatError(f"{meta_path}: key_type "
                                       f"{k['key_type']!r}")
            if k["key_type"] == 1:
                sequences.add(id(node))
            if depth + 1 < len(keys):
                node = node.setdefault(k["key"], {})
        name = ".".join(str(k["key"]) for k in keys)
        if value_type == "np.ndarray":
            value = read_zarr_array(store, name)
        elif value_type in _EMPTY_TYPES:
            empty = _EMPTY_TYPES[value_type]
            value = empty() if empty else None
        else:
            raise OrbaxFormatError(f"{meta_path}: value_type {value_type!r} "
                                   f"of {name}")
        node[keys[-1]["key"]] = value

    def build(node):
        if not isinstance(node, dict):
            return node
        if id(node) in sequences:
            return [build(node[k]) for k in sorted(node, key=int)]
        return {k: build(v) for k, v in node.items()}

    return build(root)


# ---------------------------------------------------------------- writer

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte, n = n & 0x7F, n >> 7
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _frame(magic: int, payload: bytes) -> bytes:
    """An OCDBT frame of `payload`, zstd-compressed: the inverse of
    _unframe."""
    body = (_varint(0) + _varint(1)
            + zstd_compress(payload, NODE_ZSTD_LEVEL))
    head = magic.to_bytes(4, "big") + (12 + len(body) + 4).to_bytes(
        8, "little")
    data = head + body
    return data + crc32c(data).to_bytes(4, "little")


def _file_table(paths: List[str]) -> bytes:
    """A data file table of `paths` (each with base path "")."""
    raw = [p.encode("utf-8") for p in paths]
    prefix = [len(os.path.commonprefix([a, b]))
              for a, b in zip(raw, raw[1:])]
    suffix = [len(p) - q for p, q in zip(raw, [0] + prefix)]
    return (_varint(len(raw)) + _varints(prefix) + _varints(suffix)
            + _varints([0] * len(raw))
            + b"".join(p[q:] for p, q in zip(raw, [0] + prefix)))


def _tree_entries(tree, keys=()):
    """-> [(key_metadata, value)] of `tree`'s leaves and empty nodes in
    orbax's order: dict keys and NamedTuple-like dicts as key_type 2,
    sequence indices as key_type 1."""
    if isinstance(tree, dict) and tree:
        items = [(str(k), 2, v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)) and tree:
        items = [(str(i), 1, v) for i, v in enumerate(tree)]
    else:
        return [(list(keys), tree)]
    out = []
    for key, key_type, value in items:
        out += _tree_entries(value, keys + ({"key": key,
                                             "key_type": key_type},))
    return out


def _zarr_array(name: str, value) -> Dict[bytes, bytes]:
    """The store's keys and values of one array: `.zarray` and one chunk."""
    a = np.asarray(value)
    if a.dtype not in _ZARR_DTYPES:
        raise OrbaxFormatError(f"{name}: dtype {a.dtype} (supported: "
                               f"{sorted(str(d) for d in _ZARR_DTYPES)})")
    a = a.astype(a.dtype.newbyteorder("<"), order="C", copy=False)
    zarray = {"chunks": list(a.shape),
              "compressor": {"id": "zstd", "level": CHUNK_ZSTD_LEVEL},
              "dimension_separator": ".", "dtype": _ZARR_DTYPES[a.dtype],
              "fill_value": None, "filters": None, "order": "C",
              "shape": list(a.shape), "zarr_format": 2}
    out = {f"{name}/.zarray".encode(): json.dumps(
        zarray, sort_keys=True, separators=(",", ":")).encode()}
    if a.size:
        chunk = ".".join("0" for _ in a.shape) or "0"
        out[f"{name}/{chunk}".encode()] = zstd_compress(a, CHUNK_ZSTD_LEVEL)
    return out


def _leaf_node(entries: Dict[bytes, bytes], data_file: str
               ) -> Tuple[bytes, List[bytes]]:
    """A b-tree leaf (height 0) of every key -> (its payload, the values
    it keeps in `data_file`, to be written there in order from offset
    0)."""
    keys = sorted(entries)
    prefix = [len(os.path.commonprefix([a, b]))
              for a, b in zip(keys, keys[1:])]
    values = [entries[k] for k in keys]
    kinds = bytes(int(len(v) > MAX_INLINE_VALUE_BYTES) for v in values)
    offsets, indirect, at = [], [], 0
    for v, kind in zip(values, kinds):
        if kind:
            offsets.append(at)
            indirect.append(v)
            at += len(v)
    payload = (b"\x00" + _file_table([data_file] if indirect else [])
               + _varint(len(keys)) + _varints(prefix)
               + _varints(len(k) - q for k, q in zip(keys, [0] + prefix))
               + b"".join(k[q:] for k, q in zip(keys, [0] + prefix))
               + _varints(len(v) for v in values) + kinds
               + _varints([0] * len(offsets)) + _varints(offsets)
               + b"".join(v for v, kind in zip(values, kinds) if not kind))
    if len(payload) > MAX_DECODED_NODE_BYTES:
        raise OrbaxFormatError(f"the leaf node would decode to "
                               f"{len(payload)} bytes, over "
                               f"{MAX_DECODED_NODE_BYTES}")
    return payload, indirect


def write_orbax_checkpoint(path: str, tree: Dict[str, Any]) -> None:
    """Write `tree` (nested dicts and lists of numpy arrays, None and
    empty dicts / lists) as the checkpoint directory `path`, which must
    not exist: what orbax's StandardCheckpointer().save(path, tree)
    writes, in the layout of this module's docstring."""
    path = os.path.abspath(path)
    init_ns = time.time_ns()
    tree_meta, entries = {}, {}
    for keys, value in _tree_entries(tree):
        label = str(tuple(k["key"] for k in keys))
        if value is None or isinstance(value, (dict, list, tuple)):
            empty = {type(None): "None", dict: "Dict", list: "List",
                     tuple: "List"}[type(value)]
            value_meta = {"value_type": empty, "skip_deserialize": True}
        else:
            value_meta = {"value_type": "np.ndarray",
                          "skip_deserialize": False}
            entries.update(_zarr_array(".".join(k["key"] for k in keys),
                                       value))
        tree_meta[label] = {"key_metadata": keys,
                            "value_metadata": value_meta}
    if not entries:
        raise OrbaxFormatError(f"{path}: a tree without arrays")
    os.makedirs(path)
    data_file = f"d/{os.urandom(16).hex()}"
    payload, indirect = _leaf_node(entries, data_file)
    node = _frame(NODE_MAGIC, payload)
    indirect_bytes = sum(map(len, indirect))
    os.makedirs(os.path.join(path, "d"))
    with open(os.path.join(path, data_file), "wb") as f:
        for value in indirect:
            f.write(value)
        f.write(node)
    manifest = (os.urandom(16) + _varint(0)
                + _varint(MAX_INLINE_VALUE_BYTES)
                + _varint(MAX_DECODED_NODE_BYTES)
                + bytes([VERSION_TREE_ARITY_LOG2])
                + _varint(1) + NODE_ZSTD_LEVEL.to_bytes(4, "little")
                + _file_table([data_file])
                # one version: generation 1, a root leaf in file 0
                + _varint(1) + _varint(1) + b"\x00" + _varint(0)
                + _varint(indirect_bytes) + _varint(len(node))
                + _varint(len(entries)) + _varint(len(node))
                + _varint(indirect_bytes)
                + time.time_ns().to_bytes(8, "little")
                + _varint(0))                   # no version tree nodes
    with open(os.path.join(path, "manifest.ocdbt"), "wb") as f:
        f.write(_frame(MANIFEST_MAGIC, manifest))
    with open(os.path.join(path, "_METADATA"), "w", encoding="utf-8") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w",
              encoding="utf-8") as f:
        json.dump({"item_handlers": CHECKPOINT_HANDLER, "metrics": {},
                   "performance_metrics": {},
                   "init_timestamp_nsecs": init_ns,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)


def save_mdd_tpu_checkpoint(directory: str, name: str,
                            state_dict: Dict[str, Any],
                            meta: Dict[str, Any], optimizer=None,
                            model=None) -> str:
    """mdd_tpu's save_checkpoint (mdd_tpu/train/checkpoint.py) for the
    port's state: `<directory>/<name>/` holds {params, batch_stats} and,
    given a torch Adam or its state_dict, `opt_state` (which needs
    `model` for the parameters' names); `<name>.meta.json` holds `meta`.
    Returns the checkpoint's path.

    As mdd_tpu's: the checkpoint is written to a temporary sibling with
    its meta, then swapped in, so an interrupted save never destroys the
    previous checkpoint."""
    from mdd_tpu_torch.convert import torch_adam_to_optax, torch_to_flax

    params, batch_stats = torch_to_flax(state_dict)
    tree: Dict[str, Any] = {"params": params, "batch_stats": batch_stats}
    if optimizer is not None:
        if model is None:
            raise ValueError("writing the optimizer state needs the model "
                             "(its parameters' names)")
        tree["opt_state"] = torch_adam_to_optax(optimizer, model)
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, name))
    tmp = f"{path}.tmp-{os.getpid()}"
    old = f"{path}.old-{os.getpid()}"
    for p in (tmp, old):
        if os.path.exists(p):
            shutil.rmtree(p)
    write_orbax_checkpoint(tmp, tree)
    with open(tmp + ".meta.json", "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2, default=str)
    # swap: retire the old checkpoint only after the new one is complete
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    os.replace(tmp + ".meta.json", path + ".meta.json")
    if os.path.exists(old):
        shutil.rmtree(old)
    return path


def load_mdd_tpu_checkpoint(directory: str, name: str):
    """-> (state_dict on the CPU, meta dict) of mdd_tpu's checkpoint
    `<directory>/<name>/` and its `<name>.meta.json` (an empty meta where
    that file is missing, as mdd_tpu's load_checkpoint gives)."""
    from mdd_tpu_torch.convert import flax_to_torch

    path = os.path.abspath(os.path.join(directory, name))
    tree = read_orbax_checkpoint(path, only=("params", "batch_stats"))
    state = flax_to_torch(tree["params"], tree["batch_stats"])
    meta: Dict[str, Any] = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json", "r", encoding="utf-8") as f:
            meta = json.load(f)
    return state, meta
