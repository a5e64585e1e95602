"""The trained product — the JAX package's scripts/bench_trained_product.py
configuration in float32 — through the port against the JAX package on
the CPU: ckpt/yolo (YOLOv11-s@640) and ckpt/sam2 (Hiera-t@512), read by
the port's own checkpoint reader and given to both packages (the leaves
are byte-equal to orbax's, test_torch_port_checkpoint.py), and the
trained crop reader ckpt/reader as the VLM client of each. Eval images
are decoded by each package's own image reader. `analyze()` followed by
`generate_final_netlist`, and `analyze_many(finalize=True)`, must give
byte-equal final netlists (with values), valueless netlists, boxes,
directions and stage-2 rows."""
import dataclasses
import logging
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from circuitvision_tpu.core.config import DetectorConfig as JDet
from circuitvision_tpu.core.config import PipelineConfig as JPipe
from circuitvision_tpu.core.config import sam2_hiera_preset
from circuitvision_tpu.enrich.trained_reader import load_trained_reader as jax_reader
from circuitvision_tpu.io.image_io import load_image as jax_load_image
from circuitvision_tpu.pipeline.analyzer import CircuitAnalyzerTPU
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.enrich.trained_reader import load_trained_reader
from circuitvision_tpu_torch.io.image_io import load_image
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.models.checkpoint import load_model_checkpoint
from circuitvision_tpu_torch.ops.cuda.build import KernelError
from circuitvision_tpu_torch.pipeline import analyzer as tanalyzer
from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch

ROOT = Path(__file__).resolve().parents[1]
#: two basic circuits and an EXIF-rotated one
NAMES = ("ac_rc", "series_rl", "exif_0")


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _path(name):
    return str(ROOT / "eval_data" / "images" / f"{name}.png")


@pytest.fixture(scope="module")
def product():
    yv, ymeta = load_model_checkpoint(str(ROOT / "ckpt" / "yolo"))
    sv, smeta = load_model_checkpoint(str(ROOT / "ckpt" / "sam2"))
    d, s = ymeta["detector"], smeta["sam2"]
    jcfg = JPipe(detector=JDet(scale=d["scale"], img_size=d["img_size"],
                               num_classes=d["num_classes"], reg_max=d["reg_max"],
                               dtype="float32"),
                 sam2=sam2_hiera_preset(s["preset"], dtype="float32", **s["overrides"]),
                 use_sam2=True)
    tcfg = tconfig.PipelineConfig(
        detector=dataclasses.replace(bridge.detector_config(ymeta), dtype="float32"),
        sam2=bridge.sam2_config(smeta, dtype="float32"))
    ja = CircuitAnalyzerTPU(config=jcfg, yolo_variables=yv, sam2_variables=sv, use_sam2=True,
                            vlm_client=jax_reader(str(ROOT / "ckpt" / "reader")))
    ta = CircuitAnalyzerTorch(tcfg, bridge.state_dict_from_variables(yv),
                              bridge.state_dict_from_variables(sv), device="cpu",
                              vlm_client=load_trained_reader(str(ROOT / "ckpt" / "reader"),
                                                             device="cpu"))
    return ja, ta


def _summary(r):
    return {"final": r.netlist_text, "valueless": r.valueless_netlist_text,
            "no_vlm_dir": r.valueless_netlist_text_no_vlm_dir,
            "boxes": [(b.class_name, b.xmin, b.ymin, b.xmax, b.ymax, b.visual_id)
                      for b in r.enum_bboxes],
            "directions": [(b.class_name, b.semantic_direction, b.semantic_reason)
                           for b in r.bboxes],
            "stage2": r.vlm_stage2_output}


@pytest.mark.parametrize("name", NAMES)
def test_analyze_and_final_netlist_equal_jax(product, name):
    ja, ta = product
    ref = ja.generate_final_netlist(ja.analyze(jax_load_image(_path(name))))
    got = ta.generate_final_netlist(ta.analyze(load_image(_path(name))))
    assert _summary(got) == _summary(ref)
    assert got.vlm_stage2_output and got.nodes
    assert "Final Netlist Generation" in got.timings.timings


def test_analyze_many_finalize_equals_jax_and_serial(product):
    """Four images in chunks of two: the JAX BatchedPipeline with
    finalize=True, and the port's own analyze() + generate_final_netlist
    image by image."""
    ja, ta = product
    names = NAMES + ("golden",)
    mesh = Mesh(np.asarray(jax.devices("cpu")[:1]).reshape(1, 1), ("data", "model"))
    ref = ja.analyze_batch([jax_load_image(_path(n)) for n in names], mesh=mesh, batch_size=2,
                           finalize=True)
    got = ta.analyze_batch([load_image(_path(n)) for n in names], batch_size=2, finalize=True)
    assert [_summary(g) for g in got] == [_summary(r) for r in ref]
    for n, g in zip(names, got):
        serial = ta.generate_final_netlist(ta.analyze(load_image(_path(n))))
        assert _summary(g) == _summary(serial), n
    assert any(line.split()[-1] != "None" for g in got for line in g.netlist_text.splitlines())


def test_reader_device_fault_reraises_in_every_stage(product, monkeypatch):
    """A kernel fault, or a CUDA, cuDNN or cuBLAS error, in the reader's
    forward is never swallowed: not by stage [4], not by the value pass."""
    _ja, ta = product
    img = load_image(_path("ac_rc"))
    done = ta.analyze(img)
    model = ta.vlm_client.model
    for exc in (KernelError("launch failed"), RuntimeError("CUDA error: an illegal memory access"),
                RuntimeError("cuDNN error: CUDNN_STATUS_EXECUTION_FAILED"),
                RuntimeError("CUDA error: CUBLAS_STATUS_EXECUTION_FAILED when calling `cublasSgemm`")):
        def boom(*a, _exc=exc, **k):
            raise _exc
        monkeypatch.setattr(model, "forward", boom)
        with pytest.raises(type(exc)):
            ta.analyze(img)
        with pytest.raises(type(exc)):
            ta.generate_final_netlist(done)
        with pytest.raises(type(exc)):
            ta.finalize_netlists([done])
        monkeypatch.undo()


def test_value_pass_ladders_keep_the_valueless_netlist(product, monkeypatch, caplog):
    """A read that fails on the data, or rows that do not merge, keep the
    valueless netlist, as the JAX ladders do."""
    _ja, ta = product
    img = load_image(_path("ac_rc"))
    caplog.set_level(logging.ERROR)

    def bad_read(images, boxes):
        raise ValueError("unreadable")
    r = ta.analyze(img)
    monkeypatch.setattr(ta.vlm_client, "get_labels_batch_boxes", bad_read)
    assert ta.generate_final_netlist(r).netlist_text == r.valueless_netlist_text
    assert ta.finalize_netlists([r])[0].netlist_text == r.valueless_netlist_text
    monkeypatch.setattr(ta.vlm_client, "get_labels_batch_boxes",
                        lambda images, boxes: [["not a row"] for _ in images])
    r = ta.analyze(img)
    assert ta.generate_final_netlist(r).netlist_text == r.valueless_netlist_text
    assert r.vlm_stage2_output == ["not a row"]
    assert "VLM merge failed" in caplog.text and "VLM labeling failed" in caplog.text

    def broken_stage4(*a, **k):
        raise ValueError("no crops")
    monkeypatch.setattr(tanalyzer, "enrich_directions", broken_stage4)
    r = ta.analyze(img)
    assert r.nodes and all(b.semantic_direction is None for b in r.bboxes)


def test_whole_image_clients_are_refused(product):
    """A client that reads whole images, or one that reads the direction
    crops one at a time, is refused: the drawn enumeration image and the
    per-crop dispatch serve only the HTTP clients, which are not ported."""
    _ja, ta = product

    class WholeImage:
        def get_labels(self, enum_image):
            return []

        def get_directions_batch(self, crops, classes):
            return [("UNKNOWN", "UNKNOWN")] * len(crops)

    class PerCrop:
        def get_labels_batch_boxes(self, images, boxes):
            return [[] for _ in images]

        def get_direction(self, crop, cls):
            return "UNKNOWN", "UNKNOWN"

    for client, hook in ((WholeImage(), "get_labels_batch_boxes"),
                         (PerCrop(), "get_directions_batch")):
        with pytest.raises(NotImplementedError, match=f"no {hook}: .*enumeration image"):
            CircuitAnalyzerTorch(ta.cfg, ta.yolo.state_dict(), None, device="cpu",
                                 vlm_client=client)


@pytest.mark.parametrize("key", ["GEMINI_API_KEY", "OPENROUTER_API_KEY"])
def test_analyzer_builds_with_an_http_key_set(product, monkeypatch, key):
    """The HTTP clients' keys, which users of the JAX package have set,
    name clients the port does not have: without vlm_client= the
    analyzer builds with no client, and runs the valueless path."""
    _ja, ta = product
    monkeypatch.delenv("CIRCUITVISION_VLM", raising=False)
    monkeypatch.setenv(key, "k")
    a = CircuitAnalyzerTorch(ta.cfg, ta.yolo.state_dict(), None, device="cpu")
    assert a.vlm_client is None
