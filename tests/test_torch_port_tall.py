"""The enumeration image on tall images, and the last two helpers, of
the PyTorch port against the JAX package on the CPU (the digits alone
against cv2 at every size are in test_torch_port_digits.py):

  * enumerate_components byte-equal to the JAX package's cv2 drawing,
    with the same visual ids, at 4097, 4200 (thickness 7), 6000, 9000 and
    16384 rows;
  * analyze() on a drawing 4200 rows high at the tiny config, detections
    injected and the classical mask, against the JAX analyzer: the same
    netlist and a byte-equal enumeration image;
  * core/geometry.point_near_bbox against the JAX predicate (hypothesis)
    and the vectorised matcher; models/yolo/model.param_count against
    JAX's on the shipped ckpt/yolo and a seeded s@640.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from circuitvision_tpu.core import geometry as jgeometry
from circuitvision_tpu.core.config import DetectorConfig as JDet
from circuitvision_tpu.core.config import PipelineConfig as JPipe
from circuitvision_tpu.core.config import SAM2Config as JSAM2Config
from circuitvision_tpu.core.types import BBox as JBox
from circuitvision_tpu.models import checkpoint as jcheckpoint
from circuitvision_tpu.models.yolo import model as jyolo
from circuitvision_tpu.pipeline.analyzer import CircuitAnalyzerTPU
from circuitvision_tpu.topology import enumerate_components as jenum
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.core import geometry
from circuitvision_tpu_torch.core.types import BBox
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.models import checkpoint as tcheckpoint
from circuitvision_tpu_torch.models.yolo import model as tyolo
from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch
from circuitvision_tpu_torch.topology import enumerate_components as tenum
from circuitvision_tpu_torch.topology import matching

TINY_SAM2 = dict(resolution=128, embed_dim=16, num_heads=1, stages=(1, 2, 3, 1),
                 global_att_blocks=(5,), window_spec=(4, 2, 6, 2),
                 backbone_channel_list=(128, 64, 32, 16), d_model=32, decoder_mlp_dim=64,
                 iou_head_hidden_dim=32, dtype="float32")
TINY_DET = dict(scale="n", img_size=128, num_classes=64, dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's tests, restored after: the
    suite runs six workers on eight cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sizes(rows):
    """The enumeration's (font scale, thickness) on an image `rows` high."""
    return max(0.4, rows / 900.0), int(max(1, rows / 600.0))


def _tall_page(rows, cols=420, seed=0):
    rng = np.random.default_rng(seed)
    img = np.full((rows, cols, 3), 255, np.uint8)
    img[rows // 2, :] = 0
    img[:, cols // 3] = 0
    boxes = [BBox("text", 1.0, cols // 2, 0, cols // 2 + cols // 8, max(1, rows // 10))]
    for i in range(12):
        bw, bh = int(rng.integers(2, cols // 5)), int(rng.integers(1, rows // 12))
        x0, y0 = int(rng.integers(0, cols - bw)), int(rng.integers(0, rows - bh))
        boxes.append(BBox(("resistor", "voltage.dc", "gnd")[i % 3], 0.9, x0, y0, x0 + bw, y0 + bh))
    return img, boxes


@pytest.mark.parametrize("rows", [4097, 4200, 6000, 9000, 16384])
def test_enumeration_equals_jax_on_tall_images(rows):
    img, boxes = _tall_page(rows, seed=rows)
    if rows == 4200:
        assert _sizes(rows)[1] == 7
    j_img, j_boxes = jenum.enumerate_components(img, [JBox.from_dict(b.to_dict()) for b in boxes])
    t_img, t_boxes = tenum.enumerate_components(img, boxes)
    assert t_img.tobytes() == j_img.tobytes()
    assert [b.to_dict() for b in t_boxes] == [b.to_dict() for b in j_boxes]
    assert [b.visual_id for b in t_boxes] == list(range(1, 13))


# ------------------------------------------------------ the whole path
def _tall_circuit(rows=4200, cols=480):
    """A V + R + R loop drawn down a page `rows` high, with its boxes as
    (class, x0, y0, x1, y1): tall components, so that they cluster into
    one crop over the whole page and the analysis image stays as tall."""
    img = np.full((rows, cols, 3), 255, np.uint8)
    top, bottom, left, right, t = 80, rows - 80, 60, cols - 60, 3
    img[top:top + t, left:right] = 0
    img[bottom:bottom + t, left:right] = 0
    img[top:bottom + t, left:left + t] = 0
    img[top:bottom + t, right:right + t] = 0
    q = rows // 4
    boxes = [("voltage.dc", left - 40, q, left + 40, 3 * q),
             ("resistor", right - 40, top + 200, right + 40, top + 200 + q),
             ("resistor", right - 40, 3 * q - 100, right + 40, bottom - 200),
             ("gnd", cols // 2 - 60, bottom - 30, cols // 2 + 60, bottom + 60),
             ("text", cols // 2 - 60, top + 20, cols // 2 + 20, top + 60)]
    return img, boxes


@functools.lru_cache(maxsize=1)
def _tiny_yolo():
    return jax.tree.map(np.asarray, jyolo.init_params(jyolo.YOLOv11(num_classes=64, scale="n"),
                                                      jax.random.PRNGKey(0), img_size=128))


def test_analyze_equals_jax_on_a_tall_drawing(monkeypatch):
    img, gt = _tall_circuit()
    yv = _tiny_yolo()
    jcfg = JPipe(detector=JDet(**TINY_DET), sam2=JSAM2Config(**TINY_SAM2), use_sam2=False)
    ja = CircuitAnalyzerTPU(config=jcfg, yolo_variables=yv, use_sam2=False, vlm_client=None)
    ja.vlm_client = None
    tcfg = tconfig.PipelineConfig(detector=tconfig.DetectorConfig(**TINY_DET),
                                  sam2=tconfig.SAM2Config(**TINY_SAM2))
    ta = CircuitAnalyzerTorch(tcfg, bridge.state_dict_from_variables(yv), None, device="cpu")
    for an, cls in ((ja, JBox), (ta, BBox)):
        monkeypatch.setattr(an, "bboxes", lambda im, cls=cls: [
            cls(class_name=c, confidence=0.9, xmin=x0, ymin=y0, xmax=x1, ymax=y1)
            for c, x0, y0, x1, y1 in gt])
    with jax.default_matmul_precision("highest"):
        ref = ja.analyze(img)
    got = ta.analyze(img)
    assert got.image_for_analysis.shape[0] > 4096
    assert dataclasses.asdict(got.crop_info) == dataclasses.asdict(ref.crop_info)
    assert got.netlist_text == ref.netlist_text and got.netlist_text.strip()
    assert got.valueless_netlist_text == ref.valueless_netlist_text
    assert [b.visual_id for b in got.enum_bboxes] == [b.visual_id for b in ref.enum_bboxes] \
        == [1, 2, 3, 4]
    assert got.enum_image.tobytes() == ref.enum_image.tobytes()
    assert got.enum_image.tobytes() != got.image_for_analysis.tobytes()


# ------------------------------------------------------------ the helpers
_coord = st.floats(-50, 250, allow_nan=False, width=32) | st.integers(-50, 250)


@settings(max_examples=400, deadline=None)
@given(px=_coord, py=_coord, x0=st.integers(0, 100), y0=st.integers(0, 100),
       w=st.integers(0, 100), h=st.integers(0, 100),
       thr=st.floats(0, 40, allow_nan=False) | st.integers(0, 40))
def test_point_near_bbox_equals_jax(px, py, x0, y0, w, h, thr):
    want = jgeometry.point_near_bbox((px, py), JBox("resistor", 1.0, x0, y0, x0 + w, y0 + h), thr)
    got = geometry.point_near_bbox((px, py), BBox("resistor", 1.0, x0, y0, x0 + w, y0 + h), thr)
    assert got is want
    # the matcher's tensors take the same predicate
    t = torch.tensor
    vec = geometry.near_box(t([float(px)]), t([float(py)]), t([float(x0)]), t([float(y0)]),
                            t([float(x0 + w)]), t([float(y0 + h)]), t([float(thr)]))
    if int(px) == px and int(py) == py and np.float32(thr) == thr:  # a pixel's centre
        assert bool(vec[0]) is want
    assert matching.near_box is geometry.near_box


def test_param_count_equals_jax_on_the_shipped_detector():
    jv, _meta = jcheckpoint.load_model_checkpoint("ckpt/yolo")
    tv, meta = tcheckpoint.load_model_checkpoint("ckpt/yolo")
    want = jyolo.param_count(jv)
    assert tyolo.param_count(tv) == want
    det = meta["detector"]
    model = tyolo.YOLOv11(num_classes=det["num_classes"], scale=det["scale"])
    model.load_state_dict(bridge.state_dict_from_variables(tv))
    assert tyolo.param_count(model) == tyolo.param_count(model.state_dict()) == want


def test_param_count_equals_jax_on_a_seeded_s640():
    jv = jax.tree.map(np.asarray, jyolo.init_params(jyolo.YOLOv11(num_classes=62, scale="s"),
                                                    jax.random.PRNGKey(3), img_size=640))
    model = tyolo.YOLOv11(num_classes=62, scale="s")
    model.load_state_dict(bridge.state_dict_from_variables(jv))
    assert tyolo.param_count(model) == jyolo.param_count(jv) == tyolo.param_count(jv)
