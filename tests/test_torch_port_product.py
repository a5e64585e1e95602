"""The trained product — the JAX package's scripts/bench_trained_product.py
configuration in float32 — through the port against the JAX package on
the CPU: ckpt/yolo (YOLOv11-s@640) and ckpt/sam2 (Hiera-t@512), read by
the port's own checkpoint reader and given to both packages (the leaves
are byte-equal to orbax's, test_torch_port_checkpoint.py), and the
trained crop reader ckpt/reader as the VLM client of each. Eval images
are decoded by each package's own image reader. `analyze()` followed by
`generate_final_netlist`, and `analyze_many(finalize=True)`, must give
byte-equal final netlists (with values), valueless netlists, boxes,
directions and stage-2 rows; and with FakeVLMClient, the black-box value
pass's drawn enumeration image and final netlists."""
import dataclasses
import json
import logging
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
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
    """Kept under its old name: a client that reads whole images, and
    one that reads the direction crops one at a time, build and run as
    they do in the JAX package — the drawn enumeration image and the
    per-crop pool are ported. Each gives the JAX analyzer's final netlist
    with the same client; a client with no labels or no direction hook
    is refused."""
    ja, ta = product
    rows = [{"id": "1", "class": "voltage.ac", "value": "7"}]

    class WholeImage:
        def __init__(self):
            self.images = []

        def get_labels(self, enum_image):
            self.images.append(enum_image)
            return list(rows)

        def get_directions_batch(self, crops, classes):
            return [("UP", "SIGN")] * len(crops)

    class PerCrop:
        def get_labels_batch_boxes(self, images, boxes):
            return [list(rows) for _ in images]

        def get_direction(self, crop, cls):
            return "DOWN", "ARROW"

    jclient, img = ja.vlm_client, load_image(_path("ac_rc"))
    try:
        for make in (WholeImage, PerCrop):
            client, jc = make(), make()
            a = CircuitAnalyzerTorch(ta.cfg, ta.yolo.state_dict(), ta.sam2.state_dict(),
                                     device="cpu", vlm_client=client)
            ja.vlm_client = jc
            got = a.generate_final_netlist(a.analyze(img))
            want = ja.generate_final_netlist(ja.analyze(jax_load_image(_path("ac_rc"))))
            got_s, want_s = _summary(got), _summary(want)
            assert got_s == want_s and got.enum_image.tobytes() == want.enum_image.tobytes()
            assert got.vlm_stage2_output == rows
            if make is WholeImage:
                assert client.images[0] is got.enum_image
                assert got.enum_image.tobytes() != got.image_for_analysis.tobytes()
    finally:
        ja.vlm_client = jclient
    labels_only = type("LabelsOnly", (), {"get_labels": WholeImage.get_labels})()
    with pytest.raises(TypeError, match="no get_direction or get_directions_batch"):
        CircuitAnalyzerTorch(ta.cfg, ta.yolo.state_dict(), None, device="cpu",
                             vlm_client=labels_only)


@pytest.mark.parametrize("key", ["GEMINI_API_KEY", "OPENROUTER_API_KEY"])
def test_analyzer_builds_with_an_http_key_set(product, monkeypatch, key):
    """Kept under its old name: without vlm_client= an HTTP key gives its
    client, built from the config's EnrichConfig as the JAX
    default_client builds it (JAX enrich/client.py:300-318)."""
    from circuitvision_tpu_torch.enrich.client import GeminiVLMClient, OpenRouterVLMClient

    _ja, ta = product
    monkeypatch.delenv("CIRCUITVISION_VLM", raising=False)
    for k in ("GEMINI_API_KEY", "OPENROUTER_API_KEY"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv(key, "k")
    enrich = dataclasses.replace(ta.cfg.enrich, direction_model="dm", labels_model="lm",
                                 temperature=0.2, top_p=0.9, max_output_tokens=64)
    a = CircuitAnalyzerTorch(dataclasses.replace(ta.cfg, enrich=enrich), ta.yolo.state_dict(),
                             None, device="cpu")
    c = a.vlm_client
    if key == "GEMINI_API_KEY":
        assert isinstance(c, GeminiVLMClient)
        assert (c.direction_model, c.temperature, c.top_p, c.max_output_tokens) == \
            ("dm", 0.2, 0.9, 64)
        assert c.labels_model == "gemini-2.5-pro-exp-03-25"
    else:
        assert isinstance(c, OpenRouterVLMClient) and c.model == "lm"
    assert c.api_key == "k"


def _fakes(name):
    """The JAX and port FakeVLMClient primed with an eval label file."""
    from circuitvision_tpu.enrich.client import FakeVLMClient as JFake
    from circuitvision_tpu_torch.enrich.client import FakeVLMClient

    canned = json.loads((ROOT / "eval_data" / "labels" / f"{name}.json").read_text())
    dirs = {k: tuple(v) for k, v in canned.get("directions", {}).items()}
    return JFake(labels=canned["labels"], directions=dirs), FakeVLMClient(canned["labels"], dirs)


@pytest.fixture
def fake_clients(product):
    """Each analyzer's client swapped for a fake for one test, restored
    after."""
    ja, ta = product
    saved = ja.vlm_client, ta.vlm_client
    yield
    ja.vlm_client, ta.vlm_client = saved


def _drawn(r):
    return {**_summary(r), "enum_image": r.enum_image.tobytes()}


@pytest.mark.parametrize("name", NAMES)
def test_fake_client_final_netlist_equals_jax(product, fake_clients, name):
    """The black-box value pass with FakeVLMClient: the drawn enumeration
    image, the per-crop directions and the final netlist equal JAX's."""
    ja, ta = product
    (ja.vlm_client, ta.vlm_client) = jf, tf = _fakes(name)
    want = ja.generate_final_netlist(ja.analyze(jax_load_image(_path(name))))
    got = ta.generate_final_netlist(ta.analyze(load_image(_path(name))))
    assert _drawn(got) == _drawn(want)
    assert got.nodes and got.vlm_stage2_output
    assert got.enum_image.tobytes() != got.image_for_analysis.tobytes()
    assert (tf.label_calls, sorted(tf.direction_calls)) == (jf.label_calls,
                                                            sorted(jf.direction_calls)) == \
        (1, sorted(b.class_name for b in got.bboxes if b.semantic_direction is not None))


def test_fake_client_analyze_many_finalize_equals_jax_and_serial(product, fake_clients):
    """Four images in chunks of two with one fake client: the value pass
    through get_labels_batch, against the JAX BatchedPipeline and the
    port's own serial path."""
    ja, ta = product
    names = NAMES + ("golden",)
    (ja.vlm_client, ta.vlm_client) = jf, tf = _fakes("ac_rc")
    mesh = Mesh(np.asarray(jax.devices("cpu")[:1]).reshape(1, 1), ("data", "model"))
    want = ja.analyze_batch([jax_load_image(_path(n)) for n in names], mesh=mesh, batch_size=2,
                            finalize=True)
    got = ta.analyze_batch([load_image(_path(n)) for n in names], batch_size=2, finalize=True)
    assert [_drawn(g) for g in got] == [_drawn(w) for w in want]
    assert tf.label_batch_calls == jf.label_batch_calls == 2 and tf.label_calls == 0
    for n, g in zip(names, got):
        serial = ta.generate_final_netlist(ta.analyze(load_image(_path(n))))
        assert _drawn(serial) == _drawn(g), n
