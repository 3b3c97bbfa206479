"""Read the JAX package's orbax checkpoints without JAX, orbax or
tensorstore.

    tree = read_orbax("logdir/model_000015")   # {"state": {...}}

Counterpart of the read side of diffmvs_tpu/train/checkpoint.py:
`read_orbax(path)` returns the nested tree that
`ocp.PyTreeCheckpointer().restore(path)` gives for a checkpoint the JAX
package saved (`save_checkpoint`: orbax's StandardCheckpointer over a
host tree): numpy arrays, Python scalars, and None / {} / [] for the empty
nodes orbax keeps in its metadata alone (optax's EmptyState).

The checkpoint directory holds:
  * _METADATA: JSON, each leaf's key path ("key_metadata": key_type 1 a
    sequence index, 2 a dict key), its value type, and the storage flags
    ("use_ocdbt": true and "use_zarr3": false are the only ones read);
  * manifest.ocdbt, d/ and ocdbt.process_N/: a tensorstore OCDBT
    key-value store (tensorstore's documented "OCDBT" format: manifest,
    version tree, B+tree nodes, data files);
  * the store's keys "<name>/.zarray" and "<name>/<i>.<j>...": one zarr v2
    array per leaf, named by its key path joined with "." (orbax's
    param_name_from_keypath), each chunk zstd-compressed.

OCDBT, as this module reads it. Integers are unsigned LEB128 varints
unless named otherwise. A manifest or a B+tree node is
  magic (uint32 big-endian: 0x0cdb3a2a manifest, 0x0cdb20de node),
  length (uint64 little-endian, the whole file or node), version (0),
  compression_format (0 raw, 1 zstd: the rest is one zstd frame),
  body, crc32c (uint32 little-endian, of everything before it).
A data file table is num_files, path_prefix_length[num_files - 1] (shared
with the previous path), path_suffix_length[num_files],
base_path_length[num_files] and the suffixes; a path is relative to the
store's root. The manifest body is the config (uuid[16], manifest_kind,
max_inline_value_bytes, max_decoded_node_bytes, version_tree_arity_log2
uint8, compression_method, and for zstd its level int32) and the newest
versions: a data file table, num_versions, then per version
generation_number, root_height (uint8), the root node's data_file_id,
offset and length, num_keys, num_tree_bytes, num_indirect_value_bytes and
commit_time (uint64); an empty tree's root offset is 2^64 - 1. A node body
is height (uint8), a data file table, num_entries, key_prefix_length
[num_entries - 1], key_suffix_length[num_entries]; an interior node then
has subtree_common_prefix_length[num_entries], the key suffixes and per
child data_file_id, offset, length and the three statistics, its child's
keys being relative to the child key's first subtree_common_prefix_length
bytes; a leaf has the key suffixes, value_length[num_entries],
value_kind[num_entries] (0 inline, 1 in a data file), data_file_id and
offset for each value in a data file, then the inline values end to end.

zstd comes from the system's libzstd.so.1 through ctypes: it is the
reader's one dependency beyond numpy and the standard library. Nothing
falls back: a missing libzstd, a zarr v3 checkpoint, a store or dtype this
module does not know, a bad magic or a crc32c mismatch raises ValueError
(OSError for the library) naming the file and what was missing.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import os
from typing import Dict, Tuple

import numpy as np

LIBZSTD = "libzstd.so.1"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
NO_ROOT = 2 ** 64 - 1
_ZSTD_CONTENTSIZE_UNKNOWN = 2 ** 64 - 1
_ZSTD_CONTENTSIZE_ERROR = 2 ** 64 - 2


# ---------------------------------------------------------------------------
# zstd and crc32c
# ---------------------------------------------------------------------------

_zstd_lib = None


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _zstd():
    """libzstd.so.1, loaded once, its functions declared."""
    global _zstd_lib
    if _zstd_lib is None:
        try:
            lib = ctypes.CDLL(LIBZSTD)
        except OSError as e:
            raise OSError(
                f"orbax checkpoints need the system's {LIBZSTD} (zstd) to "
                f"decompress: it could not be loaded ({e})") from e
        size_t, ptr = ctypes.c_size_t, ctypes.c_void_p
        for name, res, args in (
                ("ZSTD_getFrameContentSize", ctypes.c_ulonglong,
                 [ctypes.c_char_p, size_t]),
                ("ZSTD_decompress", size_t,
                 [ptr, size_t, ctypes.c_char_p, size_t]),
                ("ZSTD_isError", ctypes.c_uint, [size_t]),
                ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
                ("ZSTD_createDCtx", ptr, []),
                ("ZSTD_freeDCtx", size_t, [ptr]),
                ("ZSTD_decompressStream", size_t,
                 [ptr, ctypes.POINTER(_OutBuffer),
                  ctypes.POINTER(_InBuffer)])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _zstd_lib = lib
    return _zstd_lib


def _zstd_check(lib, code, what):
    if lib.ZSTD_isError(code):
        raise ValueError(f"{what}: zstd: "
                         f"{lib.ZSTD_getErrorName(code).decode()}")
    return code


def _zstd_stream(lib, frame: bytes, what: str) -> bytes:
    """A frame whose header does not state its content size, decoded in
    1 MiB pieces."""
    src = ctypes.create_string_buffer(frame, len(frame))
    inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(frame), 0)
    piece = ctypes.create_string_buffer(1 << 20)
    parts = []
    ctx = lib.ZSTD_createDCtx()
    if not ctx:
        raise MemoryError(f"{what}: ZSTD_createDCtx failed")
    try:
        while True:
            outb = _OutBuffer(ctypes.cast(piece, ctypes.c_void_p),
                              len(piece), 0)
            left = _zstd_check(lib, lib.ZSTD_decompressStream(
                ctx, ctypes.byref(outb), ctypes.byref(inb)), what)
            parts.append(piece.raw[:outb.pos])
            if left == 0:
                break
            if inb.pos == inb.size and outb.pos < outb.size:
                raise ValueError(f"{what}: the zstd frame is truncated")
    finally:
        lib.ZSTD_freeDCtx(ctx)
    if inb.pos != inb.size:
        raise ValueError(f"{what}: {inb.size - inb.pos} bytes after the "
                         f"zstd frame")
    return b"".join(parts)


def zstd_decompress(frame: bytes, what: str, size: int = None) -> bytes:
    """One zstd frame's content. size: its length where the caller knows
    it (a zarr chunk); else the frame header's, or, where the header does
    not state it, as long as the stream runs."""
    lib = _zstd()
    n = lib.ZSTD_getFrameContentSize(frame, len(frame))
    if n == _ZSTD_CONTENTSIZE_ERROR:
        raise ValueError(f"{what}: not a zstd frame")
    if n == _ZSTD_CONTENTSIZE_UNKNOWN:
        if size is None:
            return _zstd_stream(lib, frame, what)
        n = size
    out = ctypes.create_string_buffer(max(int(n), 1))
    got = _zstd_check(lib, lib.ZSTD_decompress(out, n, frame, len(frame)),
                      what)
    if got != n:
        raise ValueError(f"{what}: zstd gave {got} bytes, expected {n}")
    return out.raw[:n]


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the OCDBT trailers hold it."""
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------

class _Reader:
    """Sequential reads over one decoded manifest or node."""

    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def _need(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError(f"{self.what}: truncated at byte {self.pos}")

    def bytes(self, n: int) -> bytes:
        self._need(n)
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.bytes(1)[0]

    def uint(self, n: int) -> int:
        return int.from_bytes(self.bytes(n), "little")

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint longer than 64 bits")

    def varints(self, n: int):
        return [self.varint() for _ in range(n)]

    def done(self):
        if self.pos != len(self.buf):
            raise ValueError(f"{self.what}: {len(self.buf) - self.pos} "
                             f"bytes left over")


def _envelope(raw: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node: magic, length, crc32c and the
    compression checked."""
    if len(raw) < 18:
        raise ValueError(f"{what}: {len(raw)} bytes is too short")
    got = int.from_bytes(raw[:4], "big")
    if got != magic:
        raise ValueError(f"{what}: bad magic {got:#010x} (expected "
                         f"{magic:#010x})")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise ValueError(f"{what}: header length {length}, {len(raw)} bytes "
                         f"read")
    want = int.from_bytes(raw[-4:], "little")
    crc = crc32c(raw[:-4])
    if crc != want:
        raise ValueError(f"{what}: crc32c mismatch (stored {want:#010x}, "
                         f"computed {crc:#010x})")
    r = _Reader(raw[12:-4], what)
    version = r.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version} (only 0 is "
                         f"known)")
    compression = r.varint()
    body = r.buf[r.pos:]
    if compression == 0:
        return body
    if compression == 1:
        return zstd_decompress(body, what)
    raise ValueError(f"{what}: compression format {compression} (0 raw and "
                     f"1 zstd are known)")


def _data_files(r: _Reader):
    """A data file table: the paths, relative to the store's root."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    r.varints(n)                    # base_path_length: part of the path
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError(f"{r.what}: data file path prefix {p} is longer "
                             f"than the previous path")
        prev = prev[:p] + r.bytes(s)
        path = prev.decode()
        if os.path.isabs(path) or ".." in path.split("/"):
            raise ValueError(f"{r.what}: data file path {path!r} leaves the "
                             f"store's directory")
        paths.append(path)
    return paths


class OcdbtStore:
    """The keys of an OCDBT store (a directory holding manifest.ocdbt) and
    their values, read from the newest version of its B+tree."""

    def __init__(self, root: str):
        self.root = root
        self._refs: Dict[bytes, Tuple] = {}
        path = os.path.join(root, "manifest.ocdbt")
        if not os.path.isfile(path):
            raise ValueError(f"{root}: no manifest.ocdbt (not an OCDBT "
                             f"checkpoint)")
        with open(path, "rb") as f:
            r = _Reader(_envelope(f.read(), MANIFEST_MAGIC, path), path)
        r.bytes(16)                                   # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{path}: manifest_kind {kind} (only the single "
                             f"file manifest, 0, is known)")
        r.varint()                                    # max_inline_value_bytes
        r.varint()                                    # max_decoded_node_bytes
        r.byte()                                      # version_tree_arity_log2
        method = r.varint()
        if method == 1:
            r.uint(4)                                 # zstd level
        elif method != 0:
            raise ValueError(f"{path}: compression method {method} (0 none "
                             f"and 1 zstd are known)")
        files = _data_files(r)
        n = r.varint()
        if n == 0:
            raise ValueError(f"{path}: the manifest holds no version")
        generation = r.varints(n)
        height = list(r.bytes(n))
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        for _ in range(3):                            # the statistics
            r.varints(n)
        for _ in range(n):
            r.uint(8)                                 # commit_time
        v = max(range(n), key=lambda i: generation[i])
        if offset[v] != NO_ROOT:
            self._walk(files[file_id[v]], offset[v], length[v], height[v],
                       b"")

    def _read(self, rel: str, offset: int, length: int) -> bytes:
        path = os.path.join(self.root, rel)
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                raw = f.read(length)
        except FileNotFoundError as e:
            raise ValueError(f"{self.root}: data file {rel} is missing") \
                from e
        if len(raw) != length:
            raise ValueError(f"{path}: {length} bytes at {offset} asked, "
                             f"{len(raw)} read")
        return raw

    def _walk(self, rel, offset, length, height, prefix):
        what = f"{os.path.join(self.root, rel)} node at {offset}"
        r = _Reader(_envelope(self._read(rel, offset, length), NODE_MAGIC,
                              what), what)
        got = r.byte()
        if got != height:
            raise ValueError(f"{what}: height {got}, its parent says "
                             f"{height}")
        files = _data_files(r)
        n = r.varint()
        pre = [0] + r.varints(max(n - 1, 0))
        suf = r.varints(n)
        common = r.varints(n) if height > 0 else None
        keys, prev = [], b""
        for p, s in zip(pre, suf):
            prev = prev[:p] + r.bytes(s)
            keys.append(prev)
        if height > 0:
            fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
            for _ in range(3):                        # the statistics
                r.varints(n)
            r.done()
            for i, key in enumerate(keys):
                self._walk(files[fid[i]], off[i], ln[i], height - 1,
                           prefix + key[:common[i]])
            return
        vlen, kind = r.varints(n), r.varints(n)
        indirect = [i for i in range(n) if kind[i] == 1]
        if any(k not in (0, 1) for k in kind):
            raise ValueError(f"{what}: value kind {sorted(set(kind))} (0 "
                             f"inline and 1 indirect are known)")
        fid, off = r.varints(len(indirect)), r.varints(len(indirect))
        for j, i in enumerate(indirect):
            self._refs[prefix + keys[i]] = (files[fid[j]], off[j], vlen[i])
        for i in range(n):
            if kind[i] == 0:
                self._refs[prefix + keys[i]] = r.bytes(vlen[i])
        r.done()

    def keys(self):
        return sorted(self._refs)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._refs

    def __getitem__(self, key: str) -> bytes:
        ref = self._refs[key.encode()]
        return ref if isinstance(ref, bytes) else self._read(*ref)


# ---------------------------------------------------------------------------
# zarr v2
# ---------------------------------------------------------------------------

def _fill(value, dtype, what):
    if value is None:
        return 0
    if isinstance(value, str):
        table = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in table or dtype.kind != "f":
            raise ValueError(f"{what}: fill_value {value!r} for {dtype}")
        return table[value]
    return value


def read_zarr(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array stored under `name` (its .zarray and chunks)."""
    what = f"{store.root}: array {name}"
    if f"{name}/.zarray" not in store:
        raise ValueError(f"{what}: no {name}/.zarray in the store")
    meta = json.loads(store[f"{name}/.zarray"])
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{what}: zarr_format {meta.get('zarr_format')}")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError as e:
        raise ValueError(f"{what}: dtype {meta['dtype']!r} has no numpy "
                         f"type") from e
    if dtype.fields is not None or dtype.kind not in "biuf":
        raise ValueError(f"{what}: dtype {meta['dtype']!r} is not a numeric "
                         f"type")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{what}: compressor {comp!r} (zstd and none are "
                         f"known)")
    if meta.get("filters"):
        raise ValueError(f"{what}: filters {meta['filters']!r}")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"{what}: order {order!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks):
        raise ValueError(f"{what}: shape {shape}, chunks {chunks}")
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value"), dtype, what), dtype)
    nbytes = int(np.prod(chunks)) * dtype.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/" + (sep.join(map(str, idx)) if idx else "0")
        if key not in store:
            continue
        raw = store[key]
        if comp is not None:
            raw = zstd_decompress(raw, f"{what} chunk {key}", nbytes)
        if len(raw) != nbytes:
            raise ValueError(f"{what}: chunk {key} holds {len(raw)} bytes, "
                             f"expected {nbytes}")
        chunk = np.frombuffer(raw, dtype).reshape(chunks, order=order)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    return out


# ---------------------------------------------------------------------------
# the checkpoint
# ---------------------------------------------------------------------------

_EMPTY = {"None": lambda: None, "Dict": dict, "List": list}
_ARRAYS = ("np.ndarray", "jax.Array", "scalar")


def _insert(tree, keys, value, what):
    """Set tree[k0][k1]... = value, making dict / sequence nodes; a
    sequence is a dict of index -> value until _lists turns it into a
    list."""
    node = tree
    for i, (k, kt) in enumerate(keys):
        last = i == len(keys) - 1
        if kt == 1:
            k = int(k)
        elif kt != 2:
            raise ValueError(f"{what}: key type {kt} (1 sequence and 2 dict "
                             f"key are known)")
        if last:
            node[k] = value
        else:
            node = node.setdefault(k, _Seq() if keys[i + 1][1] == 1 else {})


class _Seq(dict):
    """A sequence node under construction."""


def _lists(node):
    if isinstance(node, dict):
        items = {k: _lists(v) for k, v in node.items()}
        if isinstance(node, _Seq):
            if sorted(items) != list(range(len(items))):
                raise ValueError(f"sequence indices {sorted(items)}")
            return [items[i] for i in range(len(items))]
        return items
    return node


def read_orbax(path: str) -> dict:
    """The tree of an orbax checkpoint directory (one that holds
    _METADATA), as ocp.PyTreeCheckpointer().restore(path) gives it: dicts
    and lists, numpy arrays, Python scalars, and the empty nodes."""
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise ValueError(f"{path}: no _METADATA (not an orbax checkpoint "
                         f"directory)")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{meta_path}: use_zarr3 is true; this reader knows "
                         f"zarr v2 checkpoints only")
    if not meta.get("use_ocdbt"):
        raise ValueError(f"{meta_path}: use_ocdbt is not true; this reader "
                         f"knows OCDBT checkpoints only")
    store = OcdbtStore(path)
    tree = {}
    for leaf in meta["tree_metadata"].values():
        keys = [(k["key"], k["key_type"]) for k in leaf["key_metadata"]]
        vtype = leaf["value_metadata"]["value_type"]
        what = f"{meta_path}: leaf {tuple(k for k, _ in keys)}"
        if vtype in _EMPTY:
            value = _EMPTY[vtype]()
        elif vtype in _ARRAYS:
            value = read_zarr(store, ".".join(str(k) for k, _ in keys))
            if vtype == "scalar":
                value = value.item()
        else:
            raise ValueError(f"{what}: value type {vtype!r} (known: "
                             f"{', '.join(_ARRAYS + tuple(_EMPTY))})")
        _insert(tree, keys, value, what)
    return _lists(tree)
