"""The port's batched entry point (`CircuitAnalyzerTorch.analyze_batch`,
`BatchedPipeline.analyze_many`) against the JAX package's
`analyze_batch` and against the port's own `analyze()`, on the CPU.

Byte-equal throughout: boxes after NMS, crop windows, SAM2 masks, node
graphs and netlist text. The JAX side runs float32 under
`jax.default_matmul_precision("highest")` on a one-device CPU mesh.
Detections are injected where a test says so (random YOLO weights give
noise boxes), at the detection boundary of both packages, as
tests/test_batch_parity.py does for the JAX package alone.
"""
import dataclasses
import glob
import threading
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from circuitvision_tpu.core.config import DetectorConfig as JDet
from circuitvision_tpu.core.config import PipelineConfig as JPipe
from circuitvision_tpu.core.config import SAM2Config as JSAM2Config
from circuitvision_tpu.core.types import BBox as JBBox
from circuitvision_tpu.models.yolo.model import YOLOv11 as JYOLO
from circuitvision_tpu.models.yolo.model import init_params as jyolo_init
from circuitvision_tpu.pipeline import batch as jbatch
from circuitvision_tpu.pipeline.analyzer import CircuitAnalyzerTPU
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.core.types import BBox
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.ops.cuda.build import KernelError
from circuitvision_tpu_torch.pipeline import batch as tbatch
from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch
from circuitvision_tpu_torch.topology import nodes as tnodes

ROOT = Path(__file__).resolve().parents[1]
IMAGES = sorted(glob.glob(str(ROOT / "eval_data" / "images" / "*.png")))
TINY_SAM2 = dict(resolution=128, embed_dim=16, num_heads=1, stages=(1, 2, 3, 1),
                 global_att_blocks=(5,), window_spec=(4, 2, 6, 2),
                 backbone_channel_list=(128, 64, 32, 16), d_model=32, decoder_mlp_dim=64,
                 iou_head_hidden_dim=32, dtype="float32")
TINY_DET = dict(scale="n", img_size=128, num_classes=64, dtype="float32")
#: seconds a stage error may take to reach the caller
RAISE_WITHIN_S = 120


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's tests, restored after: the
    suite runs six workers on eight cores, where torch's oversubscribed
    thread pools make these tests several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _rgb(path):
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


def _mesh1():
    return Mesh(np.asarray(jax.devices("cpu")[:1]).reshape(1, 1), ("data", "model"))


def _summary(r):
    boxes = [(b.class_name, b.class_id, b.xmin, b.ymin, b.xmax, b.ymax) for b in r.bboxes_orig_nms]
    nodes = [(n.id, n.centroid, [c.persistent_uid for c in n.components]) for n in r.nodes]
    return (boxes, [b.class_name for b in r.bboxes], nodes, r.netlist_text,
            r.valueless_netlist_text, r.valueless_netlist_text_no_vlm_dir,
            [b.visual_id for b in r.enum_bboxes])


# ------------------------------------------------- drawn circuits, GT boxes
def _drawn_circuits():
    """The golden 4-node circuit and a V+R loop (test_batch_parity.py's
    drawings) with their ground-truth boxes as (class, x0, y0, x1, y1)."""
    h, w, t = 400, 500, 3
    golden = np.full((h, w, 3), 255, np.uint8)
    golden[60:60 + t, 60:440] = 0
    golden[60:340, 60:60 + t] = 0
    golden[60:340, 250:250 + t] = 0
    golden[60:340, 437:437 + t] = 0
    golden[337:337 + t, 60:440] = 0
    golden[337:380, 60:60 + t] = 0
    golden_boxes = [("voltage.dc", 45, 150, 78, 250), ("resistor", 110, 45, 190, 78),
                    ("resistor", 300, 45, 380, 78), ("capacitor.unpolarized", 235, 150, 268, 250),
                    ("gnd", 45, 355, 78, 385), ("junction", 245, 330, 258, 345),
                    ("text", 110, 10, 180, 30)]
    loop = np.full((300, 400, 3), 255, np.uint8)
    loop[50:53, 50:353] = 0
    loop[250:253, 50:353] = 0
    loop[50:253, 50:53] = 0
    loop[50:253, 350:353] = 0
    loop_boxes = [("voltage.dc", 35, 120, 70, 180), ("resistor", 150, 35, 250, 70)]
    return [(golden, golden_boxes), (loop, loop_boxes)]


CIRCUITS = _drawn_circuits()
GT = {img.shape: boxes for img, boxes in CIRCUITS}


def _boxes(cls, shape):
    return [cls(class_name=c, confidence=0.9, xmin=x0, ymin=y0, xmax=x1, ymax=y1)
            for c, x0, y0, x1, y1 in GT[shape]]


def _inject(monkeypatch, ja, ta):
    """Ground-truth detections at the detection boundary of both packages'
    single-image and batched paths; fresh copies each call, since later
    stages mutate boxes."""
    monkeypatch.setattr(ja, "bboxes", lambda img: _boxes(JBBox, img.shape))
    monkeypatch.setattr(jbatch.BatchedPipeline, "_detect_bboxes",
                        lambda self, chunk: [_boxes(JBBox, im.shape) for im in chunk])
    if ta is not None:
        monkeypatch.setattr(ta, "bboxes", lambda img: _boxes(BBox, img.shape))
    monkeypatch.setattr(tbatch.BatchedPipeline, "_detect_bboxes",
                        lambda self, chunk, imgs_dev: [_boxes(BBox, im.shape) for im in chunk])


@pytest.fixture(scope="module")
def tiny_yolo():
    return jax.tree.map(np.asarray, jyolo_init(JYOLO(num_classes=64, scale="n"),
                                               jax.random.PRNGKey(0), img_size=128))


def _tiny_pair(yv, use_sam2=False, **topo):
    jcfg = JPipe(detector=JDet(**TINY_DET), sam2=JSAM2Config(**TINY_SAM2), use_sam2=use_sam2)
    ja = CircuitAnalyzerTPU(config=jcfg, yolo_variables=yv, use_sam2=use_sam2, vlm_client=None)
    ja.vlm_client = None
    tcfg = tconfig.PipelineConfig(detector=tconfig.DetectorConfig(**TINY_DET),
                                  sam2=tconfig.SAM2Config(**TINY_SAM2),
                                  topology=tconfig.TopologyConfig(**topo))
    ta = CircuitAnalyzerTorch(tcfg, bridge.state_dict_from_variables(yv), None, device="cpu")
    return ja, ta


@pytest.mark.parametrize("batch_size", [2, 4])
def test_analyze_batch_matches_jax_tiny_injected(tiny_yolo, monkeypatch, batch_size):
    """Six drawings (three of each) through both packages' analyze_batch
    with injected detections and the classical mask: batch 4 leaves a
    partial last chunk. Also held against the port's own analyze()."""
    ja, ta = _tiny_pair(tiny_yolo)
    _inject(monkeypatch, ja, ta)
    images = [img for img, _ in CIRCUITS] * 3
    ref = ja.analyze_batch(images, mesh=_mesh1(), batch_size=batch_size)
    got = ta.analyze_batch(images, batch_size=batch_size)
    singles = [ta.analyze(img) for img in images]
    assert len(got) == len(ref) == len(images)
    for r, g, s in zip(ref, got, singles):
        assert _summary(g) == _summary(r)
        assert _summary(g) == _summary(s)
        assert g.crop_info.window == r.crop_info.window
        np.testing.assert_array_equal(g.sam_mask, r.sam_mask)
        assert g.nodes and g.netlist_text
    assert got[0].valueless_netlist_text.split("\n") == [
        "V1 0 2 None", "R1 1 0 None", "C1 1 0 None", "R2 2 1 None"]


def test_analyze_many_matches_own_analyze_with_sam2():
    """SAM2 batched over the crops of a chunk (seeded tiny weights, five eval
    images, chunks of 2): boxes, masks and netlists byte-equal to the
    port's analyze() on each image."""
    tcfg = tconfig.PipelineConfig(detector=tconfig.DetectorConfig(**TINY_DET),
                                  sam2=tconfig.SAM2Config(**TINY_SAM2))
    ymeta = {"detector": {"scale": "n", "img_size": 128, "num_classes": 64, "reg_max": 16}}
    ta = CircuitAnalyzerTorch(tcfg, bridge.seeded_state("yolo", ymeta, 0),
                              bridge.seeded_state("sam2", {"sam2": {"preset": "t", "overrides":
                                                                     TINY_SAM2}}, 1),
                              device="cpu")
    images = [_rgb(IMAGES[i]) for i in (0, 20, 40, 5, 7)]
    got = tbatch.BatchedPipeline(ta, batch_size=2).analyze_many(images)
    for img, g in zip(images, got):
        s = ta.analyze(img)
        assert _summary(g) == _summary(s)
        np.testing.assert_array_equal(g.sam_mask, s.sam_mask)
        assert g.sam_mask.dtype == np.uint8 and set(np.unique(g.sam_mask)) <= {0, 255}


@pytest.fixture(scope="module")
def shipped():
    from circuitvision_tpu.core.config import sam2_hiera_preset
    from circuitvision_tpu.models.checkpoint import load_model_checkpoint

    yv, ymeta = load_model_checkpoint(str(ROOT / "ckpt" / "yolo"))
    sv, smeta = load_model_checkpoint(str(ROOT / "ckpt" / "sam2"))
    yv, sv = jax.tree.map(np.asarray, yv), jax.tree.map(np.asarray, sv)
    d, s = ymeta["detector"], smeta["sam2"]
    jcfg = JPipe(detector=JDet(scale=d["scale"], img_size=d["img_size"],
                               num_classes=d["num_classes"], reg_max=d["reg_max"],
                               dtype="float32"),
                 sam2=sam2_hiera_preset(s["preset"], dtype="float32", **s["overrides"]))
    tcfg = tconfig.PipelineConfig(
        detector=dataclasses.replace(bridge.detector_config(ymeta), dtype="float32"),
        sam2=bridge.sam2_config(smeta, dtype="float32"))
    ja = CircuitAnalyzerTPU(config=jcfg, yolo_variables=yv, sam2_variables=sv, vlm_client=None)
    ja.vlm_client = None
    ta = CircuitAnalyzerTorch(tcfg, bridge.state_dict_from_variables(yv),
                              bridge.state_dict_from_variables(sv), device="cpu")
    return ja, ta


def test_shipped_checkpoints_analyze_batch(shipped):
    """ckpt/yolo (YOLOv11-s@640) + ckpt/sam2 (Hiera-t@512) in float32 on
    golden, loop and ac_rc at batch_size=2 (a partial last chunk): the
    port's analyze_batch against the JAX package's, boxes, crops, node
    graphs and netlists byte-equal, masks on at least 99.9 % of pixels
    (the float32 single-image masks are byte-equal today, see
    test_torch_port_pipeline.py)."""
    ja, ta = shipped
    images = [_rgb(ROOT / "eval_data" / "images" / f"{n}.png") for n in ("golden", "loop", "ac_rc")]
    ref = ja.analyze_batch(images, mesh=_mesh1(), batch_size=2)
    got = ta.analyze_batch(images, batch_size=2)
    for r, g in zip(ref, got):
        assert _summary(g) == _summary(r)
        assert g.crop_info.window == r.crop_info.window
        assert r.nodes and r.netlist_text
        assert np.mean(g.sam_mask == r.sam_mask) >= 0.999


def test_segment_stage_error_raises_without_hang(tiny_yolo, monkeypatch):
    """A segment-stage exception with many chunks still to come reaches the
    caller within RAISE_WITHIN_S seconds."""
    _ja, ta = _tiny_pair(tiny_yolo)
    monkeypatch.setattr(tbatch.BatchedPipeline, "_detect_bboxes",
                        lambda self, chunk, imgs_dev: [_boxes(BBox, im.shape) for im in chunk])

    def boom(self, staged):
        raise RuntimeError("injected segment failure")

    monkeypatch.setattr(tbatch.BatchedPipeline, "_segment_phase", boom)
    outcome = {}

    def run():
        try:
            tbatch.BatchedPipeline(ta, batch_size=2).analyze_many([CIRCUITS[1][0]] * 20)
            outcome["result"] = "returned"
        except RuntimeError as e:
            outcome["result"] = str(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=RAISE_WITHIN_S)
    assert not t.is_alive(), "analyze_many hung on a stage exception"
    assert outcome["result"] == "injected segment failure"


def test_node_ladder_reraises_device_faults(tiny_yolo, monkeypatch):
    _ja, ta = _tiny_pair(tiny_yolo)
    monkeypatch.setattr(tbatch.BatchedPipeline, "_detect_bboxes",
                        lambda self, chunk, imgs_dev: [_boxes(BBox, im.shape) for im in chunk])

    def boom(*a, **k):
        raise KernelError("launch failed")

    monkeypatch.setattr(tbatch, "finish_from_packed", boom)
    with pytest.raises(KernelError):
        ta.analyze_batch([CIRCUITS[0][0]], batch_size=1)


def test_fused_morphology_switch_on_the_cpu_changes_nothing(tiny_yolo, monkeypatch):
    """use_fused_morphology=True gives the results of False on the CPU: the
    gate mirrors JAX's, which never runs the kernel on the CPU backend."""
    _ja, off = _tiny_pair(tiny_yolo)
    _ja, on = _tiny_pair(tiny_yolo, use_fused_morphology=True)
    monkeypatch.setattr(tbatch.BatchedPipeline, "_detect_bboxes",
                        lambda self, chunk, imgs_dev: [_boxes(BBox, im.shape) for im in chunk])
    images = [img for img, _ in CIRCUITS]
    for a, b in zip(off.analyze_batch(images), on.analyze_batch(images)):
        assert _summary(a) == _summary(b)


def test_extract_nodes_batched_equals_extract_nodes():
    """The batched stage A (device subtraction, one fetch) against the
    single-image node stage on the drawings' classical masks."""
    from circuitvision_tpu_torch.topology.reclassify import segment_classical

    cfg = tconfig.TopologyConfig()
    masks = [segment_classical(img, cfg, device="cpu") for img, _ in CIRCUITS]
    boxes = [_boxes(BBox, img.shape) for img, _ in CIRCUITS]
    batched = tnodes.extract_nodes_batched(masks, boxes, cfg, device="cpu")
    for m, bb, ex in zip(masks, boxes, batched):
        single = tnodes.extract_nodes(m, bb, cfg, device="cpu")
        assert [(n.id, n.centroid, [c.persistent_uid for c in n.components]) for n in ex.nodes] \
            == [(n.id, n.centroid, [c.persistent_uid for c in n.components]) for n in single.nodes]
        assert ex.nodes


def test_finalize_is_not_ported(tiny_yolo):
    """finalize=True is ported now (the value pass runs per chunk,
    tests/test_torch_port_product.py); without a VLM client it keeps each
    image's valueless netlist, as the JAX package's finalize does."""
    _ja, ta = _tiny_pair(tiny_yolo)
    assert ta.vlm_client is None
    images = [c[0] for c in CIRCUITS]
    plain = ta.analyze_batch(images, batch_size=1)
    final = ta.analyze_batch(images, batch_size=1, finalize=True)
    assert [r.netlist_text for r in final] == [r.valueless_netlist_text for r in plain]
    assert all(r.vlm_stage2_output is None for r in final)


def test_batch_size_defaults_to_eight(tiny_yolo):
    _ja, ta = _tiny_pair(tiny_yolo)
    assert tbatch.BatchedPipeline(ta).batch_size == 8 == tconfig.BATCH_PER_DEVICE
    assert tbatch.BatchedPipeline(ta, batch_size=3).batch_size == 3


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed,h,w", [(106, 715, 975), (109, 900, 1200)])
def test_large_drawings_crop_alike(tiny_yolo, monkeypatch, seed, h, w):
    """Two of chip_smoke.py's drawings on pages past its batched band
    (600×820 to 705×970), with their drawn boxes and the classical mask:
    the cluster crop keeps part of the eight bodies and the drawn topology
    finds one node, in the JAX package as in the port, with the same crop
    and the same netlist. The band is set by the drawings, not by the
    port."""
    ja, ta = _tiny_pair(tiny_yolo)
    img, drawn = _chip_smoke().draw_schematic(seed, h=h, w=w)
    monkeypatch.setattr(ja, "bboxes", lambda im: [JBBox("resistor", 1.0, *b, class_id=10)
                                                  for b in drawn])
    monkeypatch.setattr(ta, "bboxes", lambda im: [BBox("resistor", 1.0, *b, class_id=10)
                                                  for b in drawn])
    ref, got = ja.analyze(img), ta.analyze(img)
    assert got.crop_info.window == ref.crop_info.window
    assert len(got.bboxes) == len(ref.bboxes) < len(drawn)
    assert len(got.nodes) == len(ref.nodes) == 1
    assert got.netlist_text == ref.netlist_text
