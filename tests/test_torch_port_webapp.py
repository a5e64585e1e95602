"""The port's web UI (webapp.py) over real HTTP on the CPU: the twelve
cases of tests/test_webapp.py against the port, at a tiny seeded config
(YOLOv11-n@64 with seeded weights, the classical wire mask) with a fake
box-driven VLM client, plus the images the JSON carries decoding (PIL)
to the arrays the port draws, a JPEG upload, and `cli serve` as a
process."""
import base64
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from circuitvision_tpu.eval.synth import make_circuits
from circuitvision_tpu_torch import webapp
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.core.types import AnalysisResult, BBox
from circuitvision_tpu_torch.core.viz import create_annotated_image
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch

ROOT = Path(__file__).resolve().parents[1]
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


class FakeClient:
    """A box-driven client with canned answers: value rows for stage 2 and
    a (direction, reason) per class."""

    def __init__(self, labels, directions=None):
        self.labels, self.directions = labels, directions or {}

    def get_labels_batch_boxes(self, enum_images, enum_boxes_lists):
        return [list(self.labels) for _ in enum_images]

    def get_directions_batch(self, crops, classes):
        return [self.directions.get(c, ("UNKNOWN", "UNKNOWN")) for c in classes]


def _analyzer(client):
    det = dict(scale="n", img_size=64, num_classes=62, reg_max=16)
    cfg = tconfig.PipelineConfig(detector=tconfig.DetectorConfig(**det), use_sam2=False)
    return CircuitAnalyzerTorch(cfg, bridge.seeded_state("yolo", {"detector": det}, 0), None,
                                device="cpu", vlm_client=client)


@pytest.fixture(scope="module")
def server():
    srv = webapp.make_server(
        _analyzer(FakeClient([{"id": "1", "class": "resistor", "value": "1k"}])),
        port=0, host="127.0.0.1")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _post(url, data: bytes) -> dict:
    req = urllib.request.Request(url, data=data, method="POST")
    with _OPENER.open(req, timeout=600) as resp:
        return json.loads(resp.read())


def _png(img) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _decode(b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB"))


def _wire_image():
    img = np.full((120, 160, 3), 255, np.uint8)
    img[60:63, 20:140] = 0
    return img


class TestWebApp:
    def test_index_serves_page(self, server):
        with _OPENER.open(server + "/", timeout=60) as resp:
            body = resp.read().decode()
        assert "CircuitVision" in body and "Run SPICE Analysis" in body

    def test_analyze_flow(self, server):
        img = _wire_image()
        out = _post(server + "/analyze", _png(img))
        assert "netlist_text" in out and "timings" in out
        assert isinstance(out["bboxes"], list)
        assert out["crop"] is None or {
            "applied", "window", "reason", "original_dims", "cropped_dims",
            "basis_bbox", "clustering_threshold", "text_expansions",
        } <= set(out["crop"])
        assert isinstance(out["vlm_crops"], list)
        assert isinstance(out["annotated_orig"], str) and len(out["annotated_orig"]) > 100
        assert "emptied" in out
        # the zlib-encoded PNGs decode to what the port draws
        result = webapp._STATE["result"]
        assert (_decode(out["annotated_orig"])
                == create_annotated_image(img, result.bboxes_orig_nms)).all()
        for key, arr in (("node_viz", result.node_visualization),
                         ("contour_viz", result.contour_visualization),
                         ("connection_viz", result.connection_points_visualization)):
            assert out[key] == ("" if arr is None else webapp._png_b64(arr))
            if arr is not None:
                assert (_decode(out[key]) == arr).all()
        # a JPEG of the same drawing gives analyze()'s netlist on its pixels
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=95)
        jpeg = _post(server + "/analyze", buf.getvalue())
        pixels = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        assert jpeg["netlist_text"] == (webapp._STATE["analyzer"].analyze(pixels)
                                        .netlist_text or "")

    def test_final_returns_raw_vlm_output(self, server):
        """/final carries the reference's raw-VLM debug block
        (app.py:777-791): the stage-2 list formatted python-style."""
        img = _wire_image()
        _post(server + "/analyze", _png(img))
        with webapp._STATE["lock"]:
            webapp._STATE["result"].enum_image = img
        out = _post(server + "/final", b"")
        assert out["vlm_raw"].startswith("[\n    {\n")
        assert "'class': 'resistor'" in out["vlm_raw"]

    def test_vlm_direction_gallery(self, server):
        """With oracle detections incl. a voltage source, the response
        carries the per-component direction crops and the interpreted type
        (reference app.py:643-683)."""
        c = make_circuits()[1]  # loop: V + R
        analyzer = webapp._STATE["analyzer"]
        old_bboxes, old_client = analyzer.bboxes, analyzer.vlm_client
        boxes = [BBox.from_dict(b.to_dict()) for b in c.boxes]
        analyzer.bboxes = lambda img: [BBox.from_dict(b.to_dict()) for b in boxes]
        analyzer.vlm_client = FakeClient(c.vlm_labels, {"voltage.dc": ("UP", "ARROW")})
        try:
            out = _post(server + "/analyze", _png(c.image))
        finally:
            analyzer.bboxes, analyzer.vlm_client = old_bboxes, old_client
        crops = out["vlm_crops"]
        assert crops, "expected direction crops for the voltage source"
        v = next(x for x in crops if x["class"] == "voltage.dc")
        assert v["direction"] == "UP" and v["reason"] == "ARROW"
        assert v["interpreted"] == "current.dc"
        assert isinstance(v["img"], str) and len(v["img"]) > 100

    def test_mode_endpoint(self, server):
        out = _post(server + "/mode", b"V1 1 0 0 AC 1 0\nR1 1 0 1k")
        assert out["mode"] == "AC"

    def test_simulate_endpoint(self, server):
        out = _post(server + "/simulate?freq=60", b"V1 1 0 10\nR1 1 2 1k\nR2 2 0 1k")
        assert out["ok"] and out["phasors"] == ""
        assert out["node_voltages"]["2"] == "5.000V"

    def test_simulate_sends_the_phasor_plot(self, server):
        """An AC result carries the phasor plot as a PNG, as in the JAX
        webapp: figsize 12 × 5 at 100 dpi, drawn by sim/plots.py."""
        out = _post(server + "/simulate?freq=60", b"V1 1 0 0 AC 1 0\nR1 1 2 1k\nC1 2 0 1u")
        assert out["ok"] and out["phasors"]
        img = _decode(out["phasors"])
        assert img.shape == (500, 1200, 3) and (img != 255).any()

    def test_simulate_error_surfaces(self, server):
        out = _post(server + "/simulate?freq=60", b"R1 1 0 None")
        assert not out["ok"] and "Error" in out["error"]

    def test_bad_image_returns_error(self, server):
        req = urllib.request.Request(server + "/analyze", data=b"notanimage", method="POST")
        try:
            with _OPENER.open(req, timeout=60) as resp:
                out = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            assert e.code == 500
            out = json.loads(e.read())
        assert out.get("ok") is False and out.get("error")

    def test_device_badge(self, server):
        with _OPENER.open(server + "/device", timeout=60) as resp:
            out = json.loads(resp.read())
        assert out["device"] == "CPU ×1"


class TestVlmTextEscaping:
    def test_format_vlm_output_escapes_markup(self):
        out = webapp._format_vlm_output(
            [{"id": "1", "class": "<script>alert(1)</script>", "value": None}])
        assert "<script>" not in out
        assert "&lt;script&gt;alert(1)&lt;/script&gt;" in out
        assert out.startswith("[\n    {\n")

    def test_format_vlm_output_nondict_row_escaped(self):
        out = webapp._format_vlm_output(["<img onerror=x src=y>"])
        assert "<img" not in out and "&lt;img" in out

    def test_direction_gallery_escapes_vlm_fields(self):
        crop = np.zeros((4, 4, 3), np.uint8)
        box = BBox(class_name="voltage.dc", confidence=0.9, xmin=0, ymin=0, xmax=4, ymax=4,
                   persistent_uid="voltage.dc_0_0_4_4")
        box.semantic_direction = "<B ONCLICK=X>UP"
        box.semantic_reason = "SIGN"
        result = AnalysisResult(original_image=crop)
        result.bboxes = [box]
        result.vlm_direction_crops = {box.persistent_uid: crop}
        gallery = webapp._vlm_direction_gallery(result)
        assert len(gallery) == 1
        assert "<" not in gallery[0]["direction"]
        assert "&lt;B ONCLICK=X&gt;UP" == gallery[0]["direction"]


def test_cli_serve_runs_the_web_ui():
    """`python -m circuitvision_tpu_torch.cli serve --device cpu --port 0`
    prints its port, answers the page and /device, and stops on SIGTERM."""
    env = {**os.environ, "CIRCUITVISION_VLM": "", "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen([sys.executable, "-m", "circuitvision_tpu_torch.cli", "serve",
                             "--device", "cpu", "--port", "0", "--scale", "n",
                             "--det-size", "64"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on port "), (line, proc.stderr.read()
                                                     if proc.poll() is not None else "")
        url = f"http://127.0.0.1:{int(line.split()[3])}"
        with _OPENER.open(url + "/", timeout=60) as resp:
            assert b"Run SPICE Analysis" in resp.read()
        with _OPENER.open(url + "/device", timeout=60) as resp:
            assert json.loads(resp.read()) == {"device": "CPU ×1"}
    finally:
        proc.terminate()
        out, _err = proc.communicate(timeout=60)
    assert proc.returncode == 0 and "server stopped" in out
