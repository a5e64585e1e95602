"""The small public helpers the port took on late, against the JAX
package's: `core/geometry.nms_by_area`, `ops/image.resize_nearest` and
`keep_aspect_size`, `sim/native_backend.native_available`,
`models/flops.cached_flops` and `models/sam2/neck.position_embedding_sine`.

Box lists, sizes, indices and nearest-neighbour samples must be
identical. The sine embedding is float32 sin/cos of float32 arguments of
up to 2π, computed by XLA and by torch, each within a few ulps of the
true value: within 1e-5 absolute (`SINE_ATOL`).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from circuitvision_tpu.core import geometry as jgeometry
from circuitvision_tpu.core.types import BBox as JBBox
from circuitvision_tpu.models import flops as jflops
from circuitvision_tpu.models.sam2 import neck as jneck
from circuitvision_tpu.ops import image as jimage
from circuitvision_tpu_torch.core import geometry as tgeometry
from circuitvision_tpu_torch.core.types import BBox as TBBox
from circuitvision_tpu_torch.models import flops as tflops
from circuitvision_tpu_torch.models.sam2 import neck as tneck
from circuitvision_tpu_torch.ops import image as timage
from circuitvision_tpu_torch.sim import native_backend

SINE_ATOL = 1e-5


@settings(max_examples=40, derandomize=True, deadline=None)
@given(seed=st.integers(0, 2 ** 16), n=st.integers(0, 12),
       thr=st.sampled_from([0.0, 0.3, 0.5, 0.9]))
def test_nms_by_area_matches_jax(seed, n, thr):
    rng = np.random.default_rng(seed)
    raw = []
    for i in range(n):
        x0, y0 = rng.integers(0, 60, 2)
        w, h = rng.integers(1, 40, 2)
        raw.append(("resistor" if i % 2 else "capacitor", float(rng.random()), int(x0),
                    int(y0), int(x0 + w), int(y0 + h)))
    raw += raw[:2]  # equal areas: the stable order decides
    key = lambda bs: [(b.class_name, b.confidence, b.xmin, b.ymin, b.xmax, b.ymax)  # noqa: E731
                      for b in bs]
    got = tgeometry.nms_by_area([TBBox(*r) for r in raw], iou_threshold=thr)
    ref = jgeometry.nms_by_area([JBBox(*r) for r in raw], iou_threshold=thr)
    assert key(got) == key(ref)


@pytest.mark.parametrize("shape,out", [((7, 9), (13, 4)), ((40, 30, 3), (17, 61)),
                                       ((5, 5, 2), (5, 5)), ((3, 640), (1, 1000)),
                                       ((30, 9), (61, 4))])
def test_resize_nearest_matches_jax(shape, out):
    x = np.random.default_rng(0).integers(0, 255, shape).astype(np.uint8)
    ref = np.asarray(jimage.resize_nearest(jnp.asarray(x), out))
    got = timage.resize_nearest(torch.from_numpy(x), out).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("h,w,new", [(600, 800, 600), (333, 1001, 600), (1000, 7, 600),
                                     (1, 1, 3)])
def test_keep_aspect_size_matches_jax(h, w, new):
    assert timage.keep_aspect_size(h, w, new) == jimage.keep_aspect_size(h, w, new)


def test_native_available():
    """The JAX package's answer is whether its committed library exists;
    the port's is whether g++ builds and loads its own, which it does here
    (tests/test_torch_port_sim.py solves with it)."""
    assert native_backend.native_available() is True


def test_native_available_is_false_when_the_build_fails(monkeypatch):
    import subprocess

    def fail():
        raise subprocess.CalledProcessError(1, "g++")

    monkeypatch.setattr(native_backend, "load_library", fail)
    assert native_backend.native_available() is False


def test_cached_flops_matches_jax(tmp_path, monkeypatch):
    """Both compute once, return floats, and read their cache after; the
    keys carry the same count version."""
    jpath, tpath = tmp_path / "jax.json", tmp_path / "port.json"
    monkeypatch.setattr(jflops, "_CACHE_PATH", str(jpath))
    monkeypatch.setattr(tflops, "_cache_path", lambda: tpath)
    calls = []
    for fn in (jflops.cached_flops, tflops.cached_flops):
        assert fn("k", lambda: calls.append(1) or 12) == 12.0
        assert fn("k", lambda: calls.append(1) or 99) == 12.0
    assert len(calls) == 2
    assert tflops.FLOPS_COUNT_VERSION == jflops.FLOPS_COUNT_VERSION
    assert json.loads(tpath.read_text()) == json.loads(jpath.read_text())
    tpath.write_text("not json")
    assert tflops.cached_flops("k", lambda: 5) == 5.0


@pytest.mark.parametrize("h,w,feats", [(64, 64, 256), (32, 48, 256), (7, 5, 64)])
def test_position_embedding_sine_matches_jax(h, w, feats):
    ref = np.asarray(jneck.position_embedding_sine(h, w, feats))
    got = tneck.position_embedding_sine(h, w, feats).numpy()
    assert got.shape == ref.shape == (h, w, feats) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=SINE_ATOL)
