"""The port's host and raster stages — crop, reclassification, node
extraction, contours, touch matrices, netlist text — against the JAX
package's, on the shipped eval circuits with their ground-truth wire
masks and boxes.

Everything compared here is integer or host data (boxes, crop
decisions, node graphs, netlist text, contours), so it must be
identical; no tolerance applies.
"""
import dataclasses
import glob
import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitvision_tpu.core import geometry as jgeometry
from circuitvision_tpu.core import taxonomy as jtaxonomy
from circuitvision_tpu.core.types import BBox as JBBox
from circuitvision_tpu.netlist import generate as jgen
from circuitvision_tpu.topology import contours as jcontours
from circuitvision_tpu.topology import crop as jcrop
from circuitvision_tpu.topology import enumerate_components as jenum
from circuitvision_tpu.topology import matching as jmatching
from circuitvision_tpu.topology import nodes as jnodes
from circuitvision_tpu.topology import reclassify as jreclass
from circuitvision_tpu_torch.core import geometry as tgeometry
from circuitvision_tpu_torch.core import taxonomy as ttaxonomy
from circuitvision_tpu_torch.core.types import BBox as TBBox
from circuitvision_tpu_torch.netlist import generate as tgen
from circuitvision_tpu_torch.topology import contours as tcontours
from circuitvision_tpu_torch.topology import crop as tcrop
from circuitvision_tpu_torch.topology import enumerate_components as tenum
from circuitvision_tpu_torch.topology import matching as tmatching
from circuitvision_tpu_torch.topology import nodes as tnodes
from circuitvision_tpu_torch.topology import reclassify as treclass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = sorted(os.path.basename(p)[:-4] for p in glob.glob(os.path.join(ROOT, "eval_data", "images", "*.png")))
SAMPLE = NAMES[::8]  # eight circuits across the categories
TERMINAL = [n for n in NAMES if '"terminal"' in open(os.path.join(ROOT, "eval_data", "boxes", n + ".json")).read()][:4]


def _load(name):
    img = cv2.cvtColor(cv2.imread(os.path.join(ROOT, "eval_data", "images", name + ".png")), cv2.COLOR_BGR2RGB)
    mask = cv2.imread(os.path.join(ROOT, "eval_data", "masks", name + ".png"), cv2.IMREAD_GRAYSCALE)
    with open(os.path.join(ROOT, "eval_data", "boxes", name + ".json")) as f:
        boxes = json.load(f)
    return img, mask, boxes


def _boxes(cls, dicts):
    return [cls.from_dict(d) for d in dicts]


def _key(bs):
    return [dataclasses.astuple(b) for b in bs]


def _node_key(nodes):
    return [(n.id, n.centroid, n.area, n.label, [c.persistent_uid for c in n.components]) for n in nodes]


def test_taxonomy_and_geometry_copies_match():
    for name in ("CLASSES", "TRAIN_CLASSES", "ID_TO_NAME", "NETLIST_MAP", "NON_COMPONENTS",
                 "SOURCE_COMPONENTS", "MASK_PRESERVE_CLASSES", "CROP_CLUSTER_EXCLUDE",
                 "NETLIST_IGNORE_CLASSES", "USABLE_CLASSES"):
        assert dict(getattr(ttaxonomy, name)) == dict(getattr(jtaxonomy, name)) \
            if hasattr(getattr(jtaxonomy, name), "items") else \
            getattr(ttaxonomy, name) == getattr(jtaxonomy, name)
    assert len(ttaxonomy.TRAIN_CLASSES) == 64
    rng = np.random.default_rng(0)
    raw = []
    for i in range(40):
        x, y = (int(v) for v in rng.integers(0, 300, 2))
        raw.append(dict(xmin=x, ymin=y, xmax=x + int(rng.integers(5, 80)), ymax=y + int(rng.integers(5, 80)),
                        confidence=float(np.round(rng.random(), 2)), **{"class": "resistor"}))
    ref = jgeometry.nms_by_confidence(_boxes(JBBox, raw), 0.6)
    got = tgeometry.nms_by_confidence(_boxes(TBBox, raw), 0.6)
    assert _key(got) == _key(ref)


@pytest.mark.parametrize("name", SAMPLE)
def test_crop_identical(name):
    img, _mask, boxes = _load(name)
    ri, rb, rinfo = jcrop.crop_image_and_adjust_bboxes(img, _boxes(JBBox, boxes))
    gi, gb, ginfo = tcrop.crop_image_and_adjust_bboxes(img, _boxes(TBBox, boxes))
    np.testing.assert_array_equal(gi, ri)
    assert _key(gb) == _key(rb)
    assert dataclasses.asdict(ginfo) == dataclasses.asdict(rinfo)


def test_crop_reasons_for_no_crop_identical():
    img = np.zeros((200, 300, 3), np.uint8)
    cases = [
        [],  # no_elements_for_clustering
        [dict(xmin=0, ymin=0, xmax=300, ymax=200, confidence=0.9, **{"class": "resistor"})],  # too large
        [dict(xmin=10, ymin=10, xmax=20, ymax=20, confidence=0.9, **{"class": "junction"})],
    ]
    for boxes in cases:
        r = jcrop.crop_image_and_adjust_bboxes(img, _boxes(JBBox, boxes))[2]
        g = tcrop.crop_image_and_adjust_bboxes(img, _boxes(TBBox, boxes))[2]
        assert dataclasses.asdict(g) == dataclasses.asdict(r)


@pytest.mark.parametrize("name", SAMPLE)
def test_extract_nodes_and_netlist_identical(name):
    _img, mask, boxes = _load(name)
    ref = jnodes.extract_nodes(mask, _boxes(JBBox, boxes))
    got = tnodes.extract_nodes(mask, _boxes(TBBox, boxes), device="cpu", fetch_viz=True)
    assert len(got.nodes) == len(ref.nodes) > 0
    assert _node_key(got.nodes) == _node_key(ref.nodes)
    assert got.raw_node_count == ref.raw_node_count
    np.testing.assert_array_equal(got.emptied_mask, ref.emptied_mask)
    np.testing.assert_array_equal(got.enhanced_mask > 0, ref.enhanced_mask > 0)
    np.testing.assert_array_equal(got.label_image, ref.label_image)
    text_ref = jgen.stringify_netlist(jgen.generate_netlist_from_nodes(ref.nodes))
    text_got = tgen.stringify_netlist(tgen.generate_netlist_from_nodes(got.nodes))
    assert text_got == text_ref and text_got


@pytest.mark.parametrize("name", SAMPLE[:4])
def test_contours_identical(name):
    _img, mask, _boxes_ = _load(name)
    fg = mask > 0
    ref = jcontours.trace_contours(fg)
    got = tcontours.trace_contours(fg)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.vertices, r.vertices)
        assert (g.area, g.m00, g.m10, g.m01, g.rect, g.root) == (r.area, r.m00, r.m10, r.m01, r.rect, r.root)


@pytest.mark.parametrize("name", TERMINAL)
def test_reclassify_terminals_identical(name):
    img, _mask, boxes = _load(name)
    ref = jreclass.reclassify_terminals(img, _boxes(JBBox, boxes))
    got = treclass.reclassify_terminals(img, _boxes(TBBox, boxes), device="cpu")
    assert _key(got) == _key(ref)
    np.testing.assert_array_equal(treclass.segment_classical(img, device="cpu"),
                                  jreclass.segment_classical(img))


def test_touch_matrix_identical():
    _img, mask, boxes = _load(SAMPLE[0])
    fg = mask > 0
    from circuitvision_tpu.ops.cc import label_components, label_stats
    from circuitvision_tpu.ops.morphology import boundary_mask

    labels = label_components(jnp.asarray(fg), max_iters=256)
    stats = label_stats(labels, max_labels=64)
    bnd = boundary_mask(jnp.asarray(fg))
    comp = _boxes(JBBox, boxes)
    cb = np.asarray([[b.xmin, b.ymin, b.xmax, b.ymax] for b in comp], np.float32)
    ct = np.full(len(comp), 6.0, np.float32)
    cv = np.ones(len(comp), bool)
    ref = np.asarray(jmatching.touch_matrix(labels, bnd, stats.labels, stats.bbox, stats.valid,
                                            jnp.asarray(cb), jnp.asarray(ct), jnp.asarray(cv)))
    got = tmatching.touch_matrix(*(torch.from_numpy(np.array(a)) for a in (
        labels, bnd, stats.labels, stats.bbox, stats.valid, cb, ct, cv))).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ref.any()


@pytest.mark.parametrize("name", SAMPLE[:3])
def test_visual_ids_and_fallback_netlist_identical(name):
    img, _mask, boxes = _load(name)
    _img, ref_boxes = jenum.enumerate_components(img, _boxes(JBBox, boxes))
    got = tenum.assign_visual_ids(_boxes(TBBox, boxes))
    assert _key(got) == _key(ref_boxes)
    ref_text = jgen.stringify_netlist(jgen.generate_fallback_netlist(_boxes(JBBox, boxes)))
    assert tgen.stringify_netlist(tgen.generate_fallback_netlist(_boxes(TBBox, boxes))) == ref_text


_MASK = np.zeros((40, 60), np.uint8)
_RGB = np.full((40, 60, 3), 255, np.uint8)
_DEFAULT_DEVICE_CALLS = {
    "extract_nodes": lambda **kw: tnodes.extract_nodes(_MASK, [], **kw),
    "prepare_packed_raster": lambda **kw: tnodes.prepare_packed_raster(
        _MASK, [], tnodes.TopologyConfig(), **kw),
    "extract_nodes_batched": lambda **kw: tnodes.extract_nodes_batched([_MASK], [[]], **kw),
    "segment_classical": lambda **kw: treclass.segment_classical(_RGB, **kw),
    "reclassify_terminals": lambda **kw: treclass.reclassify_terminals(
        _RGB, [TBBox("terminal", 0.9, 5, 5, 15, 15)], **kw),
}


@pytest.mark.parametrize("entry", sorted(_DEFAULT_DEVICE_CALLS))
def test_topology_entry_points_default_to_cuda(entry, monkeypatch):
    """Without a CUDA device the topology entry points raise unless
    device="cpu" is asked for, as the analyzer does; with it they run."""
    call = _DEFAULT_DEVICE_CALLS[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        call()
    call(device="cpu")
