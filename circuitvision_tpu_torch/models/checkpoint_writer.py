"""Orbax checkpoints written with numpy, ctypes and the standard library.

Counterpart of the JAX package's `models/checkpoint.py` `save_variables`
(:22) and `save_model_checkpoint` (:54), which write through orbax and
tensorstore; the card's machine has neither. It writes what orbax's
PyTreeCheckpointer writes for a tree of numpy arrays, in the layout the
reader (`models/checkpoint.py`) describes:

  * `_METADATA` (JSON): each leaf's key path (dict keys) and its value
    type, "np.ndarray" — orbax restores such a tree without a template,
    `_CHECKPOINT_METADATA` or `_sharding` (orbax writes no `_sharding`
    for numpy leaves), so neither is written;
  * one zarr v2 array a leaf under the key prefix `a.b.c` of its path:
    `a.b.c/.zarray` and its chunks, each a zstd frame (level 1) of
    C-order little-endian bytes; an array is one chunk unless it holds
    more than CHUNK_BYTES, and is then cut along its leading axes;
  * an OCDBT store of one version with orbax's configuration (values up
    to 1024 bytes inline, zstd-compressed nodes): one data file
    `d/<uuid>` holding the larger values and, after them, the b-tree's
    single leaf node, and `manifest.ocdbt` naming that node as the root.

A leaf must be a numpy array or scalar of a dtype the reader takes
(bool, integer, float, complex); any other leaf (bfloat16, object,
structured, a tensor) raises `CheckpointFormatError` naming it, and
nothing is cast. Nodes are dicts with string keys. The checkpoint is
built in a sibling directory and renamed into place; an existing
checkpoint at the path is replaced, any other existing directory
refused. `tests/test_torch_port_ckpt_write.py` reads what this writes
back through orbax, tensorstore and the port's reader.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import struct
import time
import uuid
from typing import Mapping

import numpy as np

from ..io.zstd import compress
from .checkpoint import BTREE_MAGIC, MANIFEST_MAGIC, CheckpointFormatError, crc32c

#: orbax's OCDBT configuration: values up to this many bytes sit in the
#: b-tree node, larger ones in the data file
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
#: largest zarr chunk, in bytes
CHUNK_BYTES = 1 << 24
#: zstd level of the zarr chunks, as orbax writes them
ZARR_ZSTD_LEVEL = 1
_DICT_KEY = 2


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _common_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _frame(magic: int, payload: bytes) -> bytes:
    """An OCDBT file or node: magic, length, version 0, zstd, payload,
    CRC-32C."""
    body = _varint(0) + _varint(1) + compress(payload, 0)
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(body) + 4)
    data = head + body
    return data + struct.pack("<I", crc32c(data))


def _data_file_table(paths: list[str]) -> bytes:
    """Each path shares a prefix with the one before it; base paths are
    empty (the files lie under the store's own root)."""
    raw = [p.encode() for p in paths]
    prefix = [_common_prefix(a, b) for a, b in zip(raw, raw[1:])]
    suffix = [r[p:] for r, p in zip(raw, [0] + prefix)]
    return (_varint(len(raw)) + _varints(prefix) + _varints(len(s) for s in suffix)
            + _varints(0 for _ in raw) + b"".join(suffix))


def _leaf_node(entries: list[tuple[bytes, bytes | int, int]], data_file: str) -> bytes:
    """A b-tree leaf of height 0 over sorted `entries` (key, inline bytes
    or the offset of the value in `data_file`, value length)."""
    keys = [k for k, _, _ in entries]
    prefix = [_common_prefix(a, b) for a, b in zip(keys, keys[1:])]
    indirect = [(i, where) for i, (_, where, _) in enumerate(entries) if isinstance(where, int)]
    payload = b"".join([
        bytes([0]),
        _data_file_table([data_file] if indirect else []),
        _varint(len(keys)), _varints(prefix),
        _varints(len(k) - p for k, p in zip(keys, [0] + prefix)),
        b"".join(k[p:] for k, p in zip(keys, [0] + prefix)),
        _varints(n for _, _, n in entries),
        _varints(int(isinstance(w, int)) for _, w, _ in entries),
        _varints(0 for _ in indirect), _varints(o for _, o in indirect),
        b"".join(w for _, w, _ in entries if not isinstance(w, int)),
    ])
    if len(payload) > MAX_DECODED_NODE_BYTES:
        raise CheckpointFormatError(f"{len(entries)} keys make a b-tree node of "
                                    f"{len(payload)} bytes, over {MAX_DECODED_NODE_BYTES}")
    return _frame(BTREE_MAGIC, payload)


def _manifest(data_file: str, node_offset: int, node_length: int, n_keys: int,
              indirect_bytes: int) -> bytes:
    """A single-file manifest of one version whose root is the leaf node."""
    payload = b"".join([
        uuid.uuid4().bytes,
        _varint(0),  # manifest kind: single file
        _varints([MAX_INLINE_VALUE_BYTES, MAX_DECODED_NODE_BYTES]),
        bytes([VERSION_TREE_ARITY_LOG2]),
        _varints([1, 0]),  # node compression zstd, default level
        _varints([0, 0, 0]),
        _data_file_table([data_file]),
        _varint(1),  # versions
        _varint(1), bytes([0]),  # generation, root height
        _varints([0, node_offset, node_length, n_keys, node_length, indirect_bytes]),
        struct.pack("<Q", time.time_ns()),
        _varint(0),  # version tree nodes
    ])
    return _frame(MANIFEST_MAGIC, payload)


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if not isinstance(k, str):
            raise CheckpointFormatError(f"key {k!r} under {prefix}: only string keys are written")
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _array(path: tuple[str, ...], leaf) -> np.ndarray:
    """A leaf as a little-endian C-order array, or CheckpointFormatError."""
    if not isinstance(leaf, (np.ndarray, np.generic)):
        raise CheckpointFormatError(f"leaf {'/'.join(path)} is a {type(leaf).__name__}; "
                                    "only numpy arrays are written")
    dtype = leaf.dtype
    if dtype.hasobject or dtype.fields or dtype.kind not in "biufc":
        raise CheckpointFormatError(f"leaf {'/'.join(path)} has dtype {dtype.name}, which the "
                                    "reader does not take; cast it first")
    return np.asarray(leaf, dtype.newbyteorder("<"), order="C")


def chunk_shape(shape: tuple[int, ...], itemsize: int) -> tuple[int, ...]:
    """The whole array, or slabs along the leading axes of at most
    CHUNK_BYTES."""
    chunks = list(shape)
    for i in range(len(shape)):
        inner = itemsize * math.prod(shape[i + 1:])
        chunks[i] = max(1, min(shape[i], CHUNK_BYTES // max(inner, 1)))
        if inner <= CHUNK_BYTES:
            break
    return tuple(chunks)


def _zarr_values(name: str, arr: np.ndarray):
    """(key, value) of the zarr v2 array `name`: its .zarray, then each
    chunk, edge chunks padded to the full chunk shape with zeros."""
    chunks = chunk_shape(arr.shape, arr.dtype.itemsize)
    meta = {"chunks": list(chunks), "compressor": {"id": "zstd", "level": ZARR_ZSTD_LEVEL},
            "dimension_separator": ".", "dtype": arr.dtype.str, "fill_value": None,
            "filters": None, "order": "C", "shape": list(arr.shape), "zarr_format": 2}
    yield f"{name}/.zarray".encode(), json.dumps(meta, sort_keys=True,
                                                 separators=(",", ":")).encode()
    grid = [-(-s // c) for s, c in zip(arr.shape, chunks)]
    for idx in np.ndindex(*grid):
        sl = tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, chunks))
        block = arr[sl]
        if block.shape != chunks:
            full = np.zeros(chunks, arr.dtype)
            full[tuple(slice(0, s) for s in block.shape)] = block
            block = full
        key = f"{name}/{'.'.join(map(str, idx)) or '0'}".encode()
        yield key, compress(np.ascontiguousarray(block).tobytes(), ZARR_ZSTD_LEVEL)


def _write(root: str, tree: Mapping) -> None:
    os.makedirs(os.path.join(root, "d"))
    data_file = f"d/{uuid.uuid4().hex}"
    entries: list[tuple[bytes, bytes | int, int]] = []
    tree_metadata = {}
    offset = 0
    with open(os.path.join(root, data_file), "wb") as f:
        for path, leaf in _leaves(tree):
            arr = _array(path, leaf)
            tree_metadata[str(path)] = {
                "key_metadata": [{"key": k, "key_type": _DICT_KEY} for k in path],
                "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}
            for key, value in _zarr_values(".".join(path), arr):
                if len(value) <= MAX_INLINE_VALUE_BYTES:
                    entries.append((key, value, len(value)))
                else:
                    f.write(value)
                    entries.append((key, offset, len(value)))
                    offset += len(value)
        entries.sort(key=lambda e: e[0])
        node = _leaf_node(entries, data_file)
        f.write(node)
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(_manifest(data_file, offset, len(node), len(entries), offset))
    with open(os.path.join(root, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)


def save_variables(path: str, tree: Mapping) -> None:
    """Write `tree`, nested dicts of numpy arrays, as an orbax PyTree
    checkpoint directory at `path` (replacing a checkpoint there)."""
    path = os.path.abspath(path)
    if os.path.isdir(path) and os.listdir(path) \
            and not os.path.exists(os.path.join(path, "_METADATA")):
        raise FileExistsError(f"{path} exists and is not an orbax checkpoint")
    tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
    try:
        _write(tmp, tree)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def save_model_checkpoint(path: str, variables: Mapping, meta: Mapping) -> None:
    """`<path>/variables` (save_variables) and `<path>/meta.json`, the
    meta as `json.dump(meta, indent=1)`: the JAX package's layout, which
    `load_model_checkpoint` of either package reads."""
    os.makedirs(path, exist_ok=True)
    save_variables(os.path.join(path, "variables"), variables)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
