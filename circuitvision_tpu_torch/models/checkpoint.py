"""Orbax checkpoints read with numpy, ctypes and the standard library,
and the converters from the reference's torch checkpoints and from HF
PaliGemma checkpoints (USAGE below).

Counterpart of the JAX package's `models/checkpoint.py`
`load_variables` (:31), `load_model_checkpoint` (:72) and its converter
entry points (:89-168) and `main` (:184), which read and write through
orbax and tensorstore; the card's machine has neither. The writer is
`models/checkpoint_writer.py`; a converter writes a bare orbax directory
(no meta.json), as the JAX package's does, which the port's CLI loads
at the flags' detector and the default SAM2Config(). An orbax
PyTree checkpoint, as the repo's `ckpt/` holds them, is:

  * `_METADATA` (JSON): the tree, one entry a leaf with its key path;
  * an OCDBT key-value store (tensorstore's "optionally-cooperative
    distributed b-tree"): `manifest.ocdbt` names the newest version's
    b-tree root; the b-tree's leaves hold each key's value inline or as a
    (data file, offset, length) reference into files under `d/` or
    `ocdbt.process_0/d/`;
  * one zarr v2 array a leaf, under the key prefix `a.b.c` of its path
    `('a', 'b', 'c')`: `a.b.c/.zarray` (JSON metadata) and one key a
    chunk, `a.b.c/0.0`, each chunk a zstd frame of C-order bytes.

The OCDBT structures are those tensorstore writes: each file or node is a
magic number (big-endian), its length (u64, little-endian), a format
version (varint 0), a compression format (varint: 0 none, 1 zstd), the
payload and a CRC-32C of everything before it; numbers are LEB128
varints, and arrays of records are stored column by column. Anything
this reader does not know — another magic, format version or
compression, a numbered manifest, a zarr compressor other than zstd, a
filter, Fortran order, zarr v3, a dtype numpy lacks, a leaf that is not
an array under dict keys and sequence indices — raises
`CheckpointFormatError` and names it.
`tests/test_torch_port_checkpoint.py` holds the reader leaf for leaf
against the orbax loader on the three shipped checkpoints and against
tensorstore on stores written to exercise the rest of the format
(interior b-tree nodes, older versions, arrays of several chunks, missing
chunks).
"""
from __future__ import annotations

import json
import os
import struct
import sys
import time
from typing import Mapping

import numpy as np

from ..io.zstd import decompress

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
#: an offset or length of all ones marks a version whose tree is empty
_NO_ROOT = 2 ** 64 - 1
#: orbax's key_type for a sequence index and for a dict key
_SEQ_KEY, _DICT_KEY = 1, 2


class CheckpointFormatError(ValueError):
    """The checkpoint holds a structure this reader does not know."""


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT checks its files and nodes."""
    c = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    """Reads varints, bytes and fixed-width integers from a payload."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, msg: str):
        raise CheckpointFormatError(f"{self.what}: {msg}")

    def varint(self) -> int:
        out = shift = 0
        while True:
            if self.pos >= len(self.data):
                self.fail("truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail("truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def end(self):
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes left over")


def _decode(data: bytes, magic: int, what: str) -> _Cursor:
    """Check an OCDBT file's or node's frame and return its payload."""
    if len(data) < 18:
        raise CheckpointFormatError(f"{what}: {len(data)} bytes is too short")
    got, length = struct.unpack(">I", data[:4])[0], struct.unpack("<Q", data[4:12])[0]
    if got != magic:
        raise CheckpointFormatError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    if length != len(data):
        raise CheckpointFormatError(f"{what}: header says {length} bytes, found {len(data)}")
    if crc32c(data[:-4]) != struct.unpack("<I", data[-4:])[0]:
        raise CheckpointFormatError(f"{what}: CRC-32C mismatch")
    head = _Cursor(data[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise CheckpointFormatError(f"{what}: format version {version}")
    body = head.data[head.pos:]
    if compression == 1:
        body = decompress(body)
    elif compression != 0:
        raise CheckpointFormatError(f"{what}: compression format {compression}")
    return _Cursor(body, what)


def _data_files(cur: _Cursor) -> list[str]:
    """A data file table: each path shares a prefix with the one before
    it; the full path is the base path followed by the rest."""
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix, base = cur.varints(n), cur.varints(n)
    paths, prev = [], b""
    for p, s, b in zip(prefix, suffix, base):
        if p > len(prev) or b > p + s:
            cur.fail("malformed data file table")
        prev = prev[:p] + cur.take(s)
        paths.append(prev.decode())
    return paths


class OcdbtStore:
    """The newest version of an OCDBT key-value store, read-only."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        path = os.path.join(self.root, "manifest.ocdbt")
        with open(path, "rb") as f:
            cur = _decode(f.read(), MANIFEST_MAGIC, path)
        cur.take(16)  # the store's uuid
        kind = cur.varint()
        if kind != 0:
            cur.fail(f"manifest kind {kind}: only a single-file manifest is read")
        cur.varints(2)  # max inline value bytes, max decoded node bytes
        cur.take(1)  # version tree arity (log2)
        method = cur.varint()
        if method == 1:
            cur.varint()  # zstd level
        elif method != 0:
            cur.fail(f"node compression method {method}")
        # three varints tensorstore writes as 0 in every store seen; a
        # non-zero one is a field this reader does not know
        if cur.varints(3) != [0, 0, 0]:
            cur.fail("unknown non-zero manifest fields after the config")
        files = _data_files(cur)
        n = cur.varint()
        generation, height = cur.varints(n), list(cur.take(n))
        file_id, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
        cur.varints(3 * n)  # keys, tree bytes, indirect value bytes
        cur.take(8 * n)  # commit times
        refs = cur.varint()  # older versions, in version tree nodes
        cur.varints(5 * refs)
        cur.take(9 * refs)  # commit times, heights
        cur.end()
        self._entries: dict[bytes, tuple] = {}
        if not n:
            return
        newest = max(range(n), key=generation.__getitem__)
        if offset[newest] != _NO_ROOT:
            self._walk(files[file_id[newest]], offset[newest], length[newest],
                       height[newest], b"")

    def _read(self, rel: str, offset: int, length: int) -> bytes:
        path = os.path.normpath(os.path.join(self.root, rel))
        if not path.startswith(self.root + os.sep):
            raise CheckpointFormatError(f"data file {rel!r} lies outside the store")
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise CheckpointFormatError(f"{rel}: {length} bytes at {offset} run past its end")
        return data

    def _walk(self, rel: str, offset: int, length: int, height: int, prefix: bytes):
        """Read the b-tree node at (rel, offset, length) and below it;
        keys of a child are stored without its subtree's common prefix."""
        what = f"b-tree node {rel}@{offset}"
        cur = _decode(self._read(rel, offset, length), BTREE_MAGIC, what)
        got = cur.take(1)[0]
        if got != height:
            cur.fail(f"height {got}, its reference says {height}")
        files = _data_files(cur)
        n = cur.varint()
        key_prefix, key_suffix = [0] + cur.varints(n - 1) if n else [], cur.varints(n)
        common = cur.varints(n) if height else None
        keys, prev = [], b""
        for p, s in zip(key_prefix, key_suffix):
            prev = prev[:p] + cur.take(s)
            keys.append(prev)
        if height:
            file_id, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(3 * n)  # keys, tree bytes, indirect value bytes
            cur.end()
            for key, c, fid, off, ln in zip(keys, common, file_id, offsets, lengths):
                self._walk(files[fid], off, ln, height - 1, prefix + key[:c])
            return
        value_len, kinds = cur.varints(n), cur.varints(n)
        if any(k not in (0, 1) for k in kinds):
            cur.fail(f"value kinds {sorted(set(kinds))}")
        indirect = [i for i, k in enumerate(kinds) if k == 1]
        file_id, offsets = cur.varints(len(indirect)), cur.varints(len(indirect))
        refs = {i: (files[f], o) for i, f, o in zip(indirect, file_id, offsets)}
        for i, key in enumerate(keys):
            if i in refs:
                self._entries[prefix + key] = (*refs[i], value_len[i])
            else:  # inline values follow in key order
                self._entries[prefix + key] = (None, cur.take(value_len[i]), value_len[i])
        cur.end()

    def keys(self) -> list[bytes]:
        return sorted(self._entries)

    def get(self, key: bytes) -> bytes | None:
        """The value stored under `key`, or None."""
        entry = self._entries.get(key)
        if entry is None:
            return None
        rel, where, length = entry
        return where if rel is None else self._read(rel, where, length)


#: zarr v2 metadata this reader takes, beside shape, chunks, dtype and fill
_ZARR_FIXED = {"zarr_format": 2, "order": "C", "filters": None}


def _zarr_array(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array under key prefix `name`."""
    raw = store.get(f"{name}/.zarray".encode())
    if raw is None:
        raise CheckpointFormatError(f"{name}: no .zarray")
    meta = json.loads(raw)
    for k, v in _ZARR_FIXED.items():
        if meta.get(k) != v:
            raise CheckpointFormatError(f"{name}: zarr {k} {meta.get(k)!r}, expected {v!r}")
    comp = meta.get("compressor")
    if not isinstance(comp, Mapping) or comp.get("id") != "zstd":
        raise CheckpointFormatError(f"{name}: compressor {comp!r}; only zstd is read")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise CheckpointFormatError(f"{name}: dimension separator {sep!r}")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError as exc:
        raise CheckpointFormatError(f"{name}: dtype {meta['dtype']!r} is not a numpy dtype") \
            from exc
    if dtype.hasobject or dtype.fields or dtype.kind not in "biufc":
        raise CheckpointFormatError(f"{name}: dtype {meta['dtype']!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise CheckpointFormatError(f"{name}: chunks {chunks} for shape {shape}")
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*(len(g) for g in grid)) if shape else [()]:
        key = f"{name}/{sep.join(map(str, idx)) or '0'}".encode()
        raw = store.get(key)
        if raw is None:
            continue  # a missing chunk holds the fill value
        data = np.frombuffer(decompress(raw), dtype)
        if data.size != int(np.prod(chunks)):
            raise CheckpointFormatError(f"{key.decode()}: {data.size} elements, chunk is "
                                        f"{chunks}")
        block = data.reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def load_variables(path: str) -> dict:
    """An orbax PyTree checkpoint directory → the same nested dict of
    numpy arrays the JAX package's `load_variables` gives."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise CheckpointFormatError(f"{path}: only OCDBT + zarr v2 checkpoints are read")
    store = OcdbtStore(path)
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value = entry["value_metadata"]
        if any(k["key_type"] not in (_SEQ_KEY, _DICT_KEY) for k in keys):
            raise CheckpointFormatError(f"{path}: {keys}: only dict keys and sequence indices "
                                        "are read")
        if value["value_type"] not in ("jax.Array", "np.ndarray") or value["skip_deserialize"]:
            raise CheckpointFormatError(f"{path}: leaf {keys} of type {value['value_type']}")
        names = [str(k["key"]) for k in keys]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(_node_key(k), {})
        node[_node_key(keys[-1])] = _zarr_array(store, ".".join(names))
    return _lists(tree)


def _node_key(key: Mapping):
    """A dict key as its string, a sequence index as an int."""
    return int(key["key"]) if key["key_type"] == _SEQ_KEY else str(key["key"])


def _lists(node):
    """Nodes keyed by sequence indices (0 … n−1) → lists, as orbax restores
    a saved list (the train checkpoints' leaf lists)."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise CheckpointFormatError(f"sequence indices {sorted(node)} are not 0 … n−1")
        return [node[i] for i in range(len(node))]
    return node


def load_model_checkpoint(path: str) -> tuple[dict, dict]:
    """(variables, meta) of a `<path>/variables` + `<path>/meta.json`
    checkpoint (JAX `save_model_checkpoint`'s layout), or of a bare orbax
    directory with meta {} (as ckpt/reader is)."""
    meta = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    var_path = os.path.join(path, "variables")
    if not os.path.isdir(var_path):
        var_path = path
    return load_variables(var_path), meta


def yolo_variables_from_checkpoint(torch_path: str, scale: str = "l", num_classes: int = 62,
                                   img_size: int = 640) -> dict:
    """Ultralytics .pt → the YOLOv11 variable tree (`img_size` changes no
    shape; it is taken for the JAX signature)."""
    import torch

    from . import bridge
    from .yolo.convert import convert_state_dict, load_ultralytics_checkpoint
    from .yolo.model import YOLOv11

    state = load_ultralytics_checkpoint(torch_path)
    with torch.device("meta"):
        model = YOLOv11(num_classes, scale)
    return convert_state_dict(state, bridge.variables_template(model))


def sam2_variables_from_checkpoint(torch_path: str, lora_alpha: float = 16.0) -> dict:
    """Fine-tuned SAM2 .pth (PEFT + wrapper) → the variable tree at the
    default SAM2Config(), the LoRA deltas folded. The file is unpickled
    (torch.load with weights_only=False, as the JAX package loads it):
    convert only files you trust."""
    import torch

    from ..core.config import SAM2Config
    from . import bridge
    from .sam2.convert import convert_state_dict
    from .sam2.wrapper import SAM2ImageSegmenter

    obj = torch.load(torch_path, map_location="cpu", weights_only=False)
    state = obj.get("state_dict", obj) if isinstance(obj, dict) else obj.state_dict()
    with torch.device("meta"):
        model = SAM2ImageSegmenter(SAM2Config())
    return convert_state_dict(state, bridge.variables_template(model), lora_alpha=lora_alpha)


def convert_yolo_checkpoint(torch_path: str, out_path: str, scale: str = "l",
                            num_classes: int = 62, img_size: int = 640) -> None:
    """Ultralytics .pt → orbax checkpoint of the YOLOv11 variable tree."""
    from .checkpoint_writer import save_variables

    save_variables(out_path, yolo_variables_from_checkpoint(torch_path, scale, num_classes,
                                                            img_size))


def convert_sam2_checkpoint(torch_path: str, out_path: str, lora_alpha: float = 16.0) -> None:
    """Fine-tuned SAM2 .pth → orbax checkpoint (see
    `sam2_variables_from_checkpoint`)."""
    from .checkpoint_writer import save_variables

    save_variables(out_path, sam2_variables_from_checkpoint(torch_path, lora_alpha))


def paligemma_variables_from_checkpoint(src: str, cfg=None) -> dict:
    """HF PaliGemma checkpoint → the variable tree at `cfg` (default the
    full PaliGemmaConfig()). `src` is a directory of `.safetensors` shards
    (read by `io/safetensors.py`; BF16 tensors become float32 leaves of
    the same values, where the JAX converter keeps them in bfloat16), else a directory's `pytorch_model*` /
    `model*` `.bin` weight shards (HF fine-tune directories also hold
    training_args.bin and the like, which are not state dicts), or one
    torch file. Torch files are unpickled (weights_only=False, as the JAX
    package loads them): convert only files you trust."""
    from .paligemma.config import PaliGemmaConfig
    from .paligemma.convert import convert_hf_state

    state: dict = {}
    if os.path.isdir(src):
        names = sorted(os.listdir(src))
        shards = [n for n in names if n.endswith(".safetensors")]
        if shards:
            from ..io.safetensors import load_file

            for shard in shards:
                state.update(load_file(os.path.join(src, shard)))
        else:
            import torch

            for n in names:
                if n.endswith(".bin") and (n.startswith("pytorch_model") or n.startswith("model")):
                    state.update(torch.load(os.path.join(src, n), map_location="cpu",
                                            weights_only=False))
    else:
        import torch

        obj = torch.load(src, map_location="cpu", weights_only=False)
        state = obj.get("state_dict", obj) if isinstance(obj, dict) else obj.state_dict()
    if not state:
        raise FileNotFoundError(f"no checkpoint tensors found at {src}")
    return convert_hf_state(state, cfg or PaliGemmaConfig())


def convert_paligemma_checkpoint(src: str, out_path: str, cfg=None) -> None:
    """HF PaliGemma checkpoint → orbax checkpoint of the variable tree (see
    `paligemma_variables_from_checkpoint`)."""
    from .checkpoint_writer import save_variables

    save_variables(out_path, paligemma_variables_from_checkpoint(src, cfg))


USAGE = """\
  python -m circuitvision_tpu_torch.models.checkpoint convert-yolo best.pt out/
      [--scale n|s|m|l|x] [--num-classes N] [--img-size S]
  python -m circuitvision_tpu_torch.models.checkpoint convert-sam2 best.pth out/
      [--lora-alpha A]
  python -m circuitvision_tpu_torch.models.checkpoint convert-paligemma hf_dir_or_file out/"""

#: --flag → (converter kwarg, parser) per command; every documented
#: converter kwarg is reachable from the CLI.
_CLI_FLAGS = {
    "convert-yolo": {
        "--scale": ("scale", str),
        "--num-classes": ("num_classes", int),
        "--img-size": ("img_size", int),
    },
    "convert-sam2": {"--lora-alpha": ("lora_alpha", float)},
    "convert-paligemma": {},
}


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    commands = {"convert-yolo": yolo_variables_from_checkpoint,
                "convert-sam2": sam2_variables_from_checkpoint,
                "convert-paligemma": paligemma_variables_from_checkpoint}
    if len(argv) < 3 or argv[0] not in commands:
        print(USAGE)
        return 1
    cmd, src, dst = argv[0], argv[1], argv[2]
    flags = _CLI_FLAGS[cmd]
    kwargs = {}
    rest = argv[3:]
    while rest:
        flag = rest[0]
        if flag not in flags or len(rest) < 2:
            print(f"unknown argument {flag!r} for {cmd}; flags: {' '.join(sorted(flags))}")
            return 1
        name, parse = flags[flag]
        kwargs[name] = parse(rest[1])
        rest = rest[2:]
    from .checkpoint_writer import save_variables

    t0 = time.perf_counter()
    tree = commands[cmd](src, **kwargs)
    t1 = time.perf_counter()
    save_variables(dst, tree)
    print(f"converted {src} -> {dst}: {t1 - t0:.3f} s to read and convert, "
          f"{time.perf_counter() - t1:.3f} s to write")
    return 0


if __name__ == "__main__":
    sys.exit(main())
