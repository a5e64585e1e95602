"""The port's orbax checkpoint reader (models/checkpoint.py, io/zstd.py)
against the JAX package's orbax loader and against tensorstore.

The shipped checkpoints must give the same leaves, byte for byte, as
`circuitvision_tpu.models.checkpoint`; stores written here with
tensorstore exercise the parts of the format the shipped ones do not
(interior b-tree nodes, older versions, several chunks, missing chunks)
and the refusals.
"""
import ctypes.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import tensorstore as ts

from circuitvision_tpu.models.checkpoint import load_model_checkpoint as jax_load
from circuitvision_tpu_torch.io import zstd
from circuitvision_tpu_torch.models import checkpoint as pc

ROOT = Path(__file__).resolve().parents[1]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("name", ["yolo", "sam2", "reader"])
def test_shipped_checkpoint_leaves_equal_orbax(name):
    """Keys, dtype, shape and bytes of every leaf, and meta, as the orbax
    loader gives them (ckpt/reader has no meta.json: meta {})."""
    path = str(ROOT / "ckpt" / name)
    got, got_meta = pc.load_model_checkpoint(path)
    ref, ref_meta = jax_load(path)
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got_meta == ref_meta
    assert (got_meta == {}) == (name == "reader")
    assert got.keys() == ref.keys() and len(got) > 30
    for k, r in ref.items():
        g = np.asarray(got[k])
        r = np.asarray(r)
        assert (g.dtype, g.shape) == (r.dtype, r.shape), k
        assert g.tobytes() == r.tobytes(), k


def _kv(path):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()


def _same_as_tensorstore(path):
    store = pc.OcdbtStore(str(path))
    kv = _kv(path)
    keys = sorted(kv.list().result())
    assert store.keys() == keys
    for k in keys:
        assert store.get(k) == kv.read(k).result().value, k
    return len(keys)


@pytest.mark.parametrize("name", ["yolo/variables", "sam2/variables", "reader"])
def test_shipped_stores_key_for_key_as_tensorstore(name):
    """Every key and value of the OCDBT store — the zarr metadata and
    the raw chunk frames — as tensorstore reads them."""
    assert _same_as_tensorstore(ROOT / "ckpt" / name) >= 68


def test_interior_nodes_and_older_versions(tmp_path):
    """A store written in 40 commits with 300-byte nodes and a version
    tree of arity 2: a b-tree of height > 0 whose children store their
    keys without the common prefix, and manifest references to older
    versions; values inline and in data files."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "version_tree_arity_log2": 1}}).result()
    for i in range(40):
        kv.write(b"key%03d/abc" % i, bytes([i]) * (i * 50)).result()
    assert _same_as_tensorstore(tmp_path) == 40
    assert pc.OcdbtStore(str(tmp_path)).get(b"key999/abc") is None


def _write_checkpoint(path, arrays, compressor=None, order="C"):
    """An orbax-style checkpoint written with tensorstore: zarr v2 arrays
    in an OCDBT store plus _METADATA. arrays: {name: (array, chunks,
    chunk indices to leave unwritten)}."""
    tree = {}
    for name, (arr, chunks, skip) in arrays.items():
        spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{path}/"},
                "path": name,
                "metadata": {"shape": list(arr.shape), "chunks": list(chunks),
                             "dtype": arr.dtype.str, "order": order,
                             "compressor": compressor or {"id": "zstd", "level": 1},
                             "fill_value": 0}}
        t = ts.open(spec, create=True).result()
        grid = [range(-(-s // c)) for s, c in zip(arr.shape, chunks)]
        for idx in np.ndindex(*(len(g) for g in grid)):
            if idx in skip:
                continue
            sl = tuple(slice(i * c, min((i + 1) * c, n))
                       for i, c, n in zip(idx, chunks, arr.shape))
            t[sl].write(arr[sl]).result()
        keys = name.split(".")
        tree[str(tuple(keys))] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in keys],
            "value_metadata": {"value_type": "jax.Array", "skip_deserialize": False}}
    (Path(path) / "_METADATA").write_text(json.dumps(
        {"tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False}))


def test_several_chunks_and_missing_chunks(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((10, 7, 3)).astype(np.float32)
    b = rng.integers(-5, 5, (9, 4)).astype(np.int32)
    _write_checkpoint(tmp_path, {"params.a.kernel": (a, (4, 3, 3), {(1, 2, 0)}),
                                 "params.b": (b, (9, 4), set())})
    got = pc.load_variables(str(tmp_path))
    want = a.copy()
    want[4:8, 6:7] = 0  # the unwritten chunk holds the fill value
    np.testing.assert_array_equal(got["params"]["a"]["kernel"], want)
    np.testing.assert_array_equal(got["params"]["b"], b)
    ref = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
                   "path": "params.a.kernel"}).result().read().result()
    np.testing.assert_array_equal(got["params"]["a"]["kernel"], ref)


@pytest.mark.parametrize("compressor,order,match", [
    ({"id": "zlib", "level": 1}, "C", "compressor"),
    (None, "F", "order"),
])
def test_other_zarr_layouts_raise(tmp_path, compressor, order, match):
    _write_checkpoint(tmp_path, {"params.w": (np.ones((4, 4), np.float32), (4, 4), set())},
                      compressor=compressor, order=order)
    with pytest.raises(pc.CheckpointFormatError, match=match):
        pc.load_variables(str(tmp_path))


def test_numbered_manifest_raises(tmp_path):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"manifest_kind": "numbered"}}).result()
    kv.write(b"a", b"x").result()
    with pytest.raises(pc.CheckpointFormatError, match="manifest kind"):
        pc.OcdbtStore(str(tmp_path))


def test_corrupt_node_raises(tmp_path):
    """One flipped byte of the b-tree root fails its CRC-32C."""
    shutil.copytree(ROOT / "ckpt" / "reader", tmp_path / "r")
    (node,) = (tmp_path / "r" / "d").iterdir()
    data = bytearray(node.read_bytes())
    data[40] ^= 1
    node.write_bytes(bytes(data))
    with pytest.raises(pc.CheckpointFormatError, match="CRC-32C"):
        pc.load_variables(str(tmp_path / "r"))


def test_zstd_frames_with_and_without_content_size():
    """Frames that state their size and OCDBT's nodes (no size in the
    header) decode through the one streaming path; a truncated frame
    raises."""
    lib = zstd.library()
    payload = bytes(range(256)) * 5000
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    cap = lib.ZSTD_compressBound(len(payload))
    buf = ctypes.create_string_buffer(cap)
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                  ctypes.c_size_t, ctypes.c_int]
    n = lib.ZSTD_compress(buf, cap, payload, len(payload), 3)
    frame = buf.raw[:n]
    assert zstd.decompress(frame) == payload
    # an OCDBT node's frame states no content size
    node = (ROOT / "ckpt" / "reader" / "d").iterdir().__next__().read_bytes()
    body = node[14:-4]
    assert body[4] & 0xC0 == 0  # no frame content size field
    leaf = zstd.decompress(body)  # a b-tree leaf: height 0, then its data files
    assert len(leaf) > len(body) and leaf[0] == 0 and b"ocdbt.process_0/d/" in leaf
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(frame[:-10])
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(body[:-10])


def test_missing_libzstd_raises_naming_it(monkeypatch):
    zstd.library.cache_clear()
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    try:
        with pytest.raises(zstd.ZstdError, match="libzstd"):
            zstd.decompress(b"\x28\xb5\x2f\xfd")
    finally:
        monkeypatch.undo()
        zstd.library.cache_clear()


def test_zstd_ignores_another_zstd_in_the_global_scope(tmp_path):
    """In a process where another libzstd sits in the global symbol scope
    (as TensorFlow's framework library does once imported; here Pillow's
    bundled copy, loaded RTLD_GLOBAL), a frame that states its content
    size still round-trips: the system libzstd is bound to its own
    symbols (failed with "Src size is incorrect" before)."""
    import PIL

    foreign = sorted(Path(PIL.__file__).parent.parent.glob("pillow.libs/libzstd*.so*"))
    assert foreign, "Pillow's bundled libzstd"
    script = tmp_path / "foreign_zstd.py"
    script.write_text(
        "import ctypes, sys\n"
        f"ctypes.CDLL({str(foreign[0])!r}, mode=ctypes.RTLD_GLOBAL)\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from circuitvision_tpu_torch.io import zstd\n"
        "data = b'circuit' * 100\n"
        "frame = zstd.compress(data)\n"
        "assert frame[4] & 0x20, 'a single-segment frame with its content size'\n"
        "assert zstd.decompress(frame) == data\n")
    run = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
