"""The port's drawings without cv2 (core/draw.py, core/hershey.py,
core/viz.py) byte-equal to cv2 5.0.0 and to the JAX package's
`core/viz.py`, which draws with it:

  * the node stage's three debug images and the annotated image on the
    first 16 eval images, fed from eval_data's masks and boxes (no model
    runs): the port's contours drawn by the port and by the JAX
    functions, the node image's base resized by the port and by cv2;
  * every printable glyph at the three sizes the drawings use, and
    getTextSize;
  * each primitive (lines of thickness 1-3, rectangles outlined and
    filled, filled circles, closed contours) on random geometry, end
    points off the image included.
"""
import glob
import json
import os
import random

import cv2
import numpy as np
import pytest

from circuitvision_tpu.core import viz as jviz
from circuitvision_tpu.core.config import TopologyConfig as JTopologyConfig
from circuitvision_tpu.core.types import BBox as JBBox
from circuitvision_tpu.topology import nodes as jnodes
from circuitvision_tpu_torch.core import draw, hershey
from circuitvision_tpu_torch.core import viz as tviz
from circuitvision_tpu_torch.core.types import BBox as TBBox
from circuitvision_tpu_torch.ops.image import resize_linear_u8
from circuitvision_tpu_torch.topology import nodes as tnodes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = sorted(os.path.basename(p)[:-4]
               for p in glob.glob(os.path.join(ROOT, "eval_data", "images", "*.png")))[:16]
SIZES = [(0.5, 1), (0.5, 2), (0.9, 2)]
PRINTABLE = [chr(c) for c in range(32, 127)]


def _load(name):
    img = cv2.cvtColor(cv2.imread(os.path.join(ROOT, "eval_data", "images", name + ".png")),
                       cv2.COLOR_BGR2RGB)
    mask = cv2.imread(os.path.join(ROOT, "eval_data", "masks", name + ".png"),
                      cv2.IMREAD_GRAYSCALE)
    with open(os.path.join(ROOT, "eval_data", "boxes", name + ".json")) as f:
        boxes = json.load(f)
    return img, mask, boxes


@pytest.mark.parametrize("name", NAMES)
def test_node_stage_drawings_equal_jax(name):
    img, mask, boxes = _load(name)
    ex = tnodes.extract_nodes(mask, [TBBox.from_dict(d) for d in boxes], device="cpu",
                              fetch_viz=True)
    if not ex.nodes:
        assert ex.contour_viz is None and ex.node_viz is None
        return
    h, w = ex.enhanced_mask.shape
    fg = ex.enhanced_mask > 0
    cfg = tnodes.TopologyConfig()
    comp_indices, comp_boxes, comp_thr, comp_valid = tnodes._component_arrays(
        ex.resized_bboxes, cfg)
    _c, _a, touch, contours = tnodes.contour_touch_stage_host(fg, float(w), cfg, comp_boxes,
                                                              comp_thr, comp_valid)
    touch = touch[:, :len(comp_indices)]
    jboxes = [JBBox.from_dict(b.to_dict()) for b in ex.resized_bboxes]
    # the contour image
    want = jviz.contour_viz((h, w), contours)
    assert ex.contour_viz.tobytes() == want.tobytes()
    # the connection points, found and drawn
    pts = tnodes._connection_points(contours, touch, ex.resized_bboxes, comp_indices, cfg)
    assert pts == jnodes._connection_points(contours, touch, jboxes, comp_indices,
                                            JTopologyConfig())
    assert ex.connection_viz.tobytes() == jviz.connection_points_viz(want, pts).tobytes()
    # the node image on cv2's resize of the emptied mask
    base = cv2.resize(ex.emptied_mask, (w, h), interpolation=cv2.INTER_LINEAR)
    assert resize_linear_u8(ex.emptied_mask, (h, w)).tobytes() == base.tobytes()
    assert ex.node_viz.tobytes() == \
        jviz.node_viz(base, ex.nodes, dict(enumerate(contours))).tobytes()
    # the annotated image with the eval boxes
    tb = [TBBox.from_dict(d) for d in boxes]
    jb = [JBBox.from_dict(d) for d in boxes]
    assert tviz.create_annotated_image(img, tb).tobytes() == \
        jviz.create_annotated_image(img, jb).tobytes()
    assert tviz.summarize_components(tb) == jviz.summarize_components(jb)


@pytest.mark.parametrize("scale,thickness", SIZES)
def test_every_glyph_equals_cv2(scale, thickness):
    """Each printable character alone, red on a random RGB background,
    and its getTextSize; then all of them in one line."""
    rng = np.random.default_rng(int(scale * 10) + thickness)
    for c in PRINTABLE + ["".join(PRINTABLE)]:
        bg = rng.integers(0, 256, (60, 40 + 25 * len(c), 3), dtype=np.uint8)
        want = bg.copy()
        cv2.putText(want, c, (7, 40), cv2.FONT_HERSHEY_SIMPLEX, scale, (255, 0, 0), thickness)
        got = draw.put_text(bg.copy(), c, (7, 40), scale, (255, 0, 0), thickness)
        assert got.tobytes() == want.tobytes(), repr(c)
        assert draw.get_text_size(c, scale, thickness) == \
            cv2.getTextSize(c, cv2.FONT_HERSHEY_SIMPLEX, scale, thickness)


@pytest.mark.parametrize("scale,thickness", SIZES)
def test_text_at_image_edges_equals_cv2(scale, thickness):
    """Strings of ids and labels clipped at every edge, and an origin
    right of the image (cv2 draws nothing)."""
    rng = random.Random(int(scale * 10) + thickness)
    for _ in range(150):
        text = "".join(rng.choice("0123456789jy_:. resistorcapacitor") for _ in range(5))
        h, w = rng.randint(5, 50), rng.randint(5, 70)
        org = (rng.randint(-30, w + 2), rng.randint(-10, h + 25))
        bg = np.random.default_rng(rng.randint(0, 1 << 30)).integers(0, 256, (h, w, 3),
                                                                      dtype=np.uint8)
        color = tuple(rng.randint(0, 255) for _ in range(3))
        want = bg.copy()
        cv2.putText(want, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale, color, thickness)
        got = draw.put_text(bg.copy(), text, org, scale, color, thickness)
        assert got.tobytes() == want.tobytes(), (text, org, (h, w))


def test_glyph_table_holds_the_drawn_sizes():
    assert set(hershey.TEXT_HEIGHT) == set(SIZES)
    for s in SIZES:
        assert sorted(hershey.glyphs(*s)) == PRINTABLE


@pytest.mark.parametrize("kind", ["line1", "line2", "line3", "rect2", "rect_filled", "circle",
                                  "contour2"])
def test_primitives_equal_cv2(kind):
    rng = random.Random(kind)
    for _ in range(250):
        h, w = rng.randint(5, 60), rng.randint(5, 60)
        color = tuple(rng.randint(0, 255) for _ in range(3))

        def pt():
            return rng.randint(-15, w + 15), rng.randint(-15, h + 15)
        bg = np.random.default_rng(rng.randint(0, 1 << 30)).integers(0, 256, (h, w, 3),
                                                                      dtype=np.uint8)
        want, got = bg.copy(), bg.copy()
        if kind.startswith("line"):
            p, q, t = pt(), pt(), int(kind[-1])
            cv2.line(want, p, q, color, t)
            draw.line(got, p, q, color, t)
        elif kind == "rect2":
            p, q = pt(), pt()
            cv2.rectangle(want, p, q, color, 2)
            draw.rectangle(got, p, q, color, 2)
        elif kind == "rect_filled":
            p, q = pt(), pt()
            cv2.rectangle(want, p, q, color, -1)
            draw.rectangle(got, p, q, color, -1)
        elif kind == "circle":
            p, r = pt(), rng.choice([1, 2, 5, 9])
            cv2.circle(want, p, r, color, -1)
            draw.circle(got, p, r, color, -1)
        else:
            poly = np.array([pt() for _ in range(rng.randint(1, 9))], np.int32)
            cv2.drawContours(want, [poly.reshape(-1, 1, 2)], -1, color, 2)
            draw.draw_contours(got, [poly], color, 2)
        assert got.tobytes() == want.tobytes()
