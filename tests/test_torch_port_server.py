"""The port's micro-batching server (`pipeline/server.py`) on the CPU.

The cases of tests/test_server.py on the port's `BatchingExecutor` and
HTTP front end, at the tiny config with the injected detections of
tests/test_torch_port_batch.py: served netlists byte-equal to the JAX
package's `analyze_batch` on the same images and weights (with and
without the value pass), coalescing, the deadline flush, a lone request
that does not wait for a second one, the backlog rule, an isolated
failed batch, submit after close, the HTTP round trip with /stats and
/metrics; and what the port adds: a device fault (a KernelError, a CUDA
error) breaks the executor and /healthz answers 503; SIGTERM to the
CLI's `serve-batch` drains and exits 0.
"""
import copy
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import cv2
import pytest

from circuitvision_tpu.core.types import BBox as JBBox
from circuitvision_tpu.pipeline import batch as jbatch
from circuitvision_tpu_torch.core.types import BBox
from circuitvision_tpu_torch.io.image_io import decode_image
from circuitvision_tpu_torch.ops.cuda.build import KernelError
from circuitvision_tpu_torch.pipeline import batch as tbatch
from circuitvision_tpu_torch.pipeline.server import BatchingExecutor, _Request, make_server

from .test_torch_port_batch import (  # noqa: F401  (fixtures)
    CIRCUITS,
    ROOT,
    _boxes,
    _exact_matmuls,
    _mesh1,
    _summary,
    _tiny_pair,
    tiny_yolo,
)

GOLDEN, LOOP = CIRCUITS[0][0], CIRCUITS[1][0]
#: seconds any one request may take here before the test calls it hung
WAIT_S = 120
#: HTTP to the local server only, whatever proxy the environment names
HTTP = urllib.request.build_opener(urllib.request.ProxyHandler({}))


class BoxClient:
    """A box-driven VLM client both packages take: one value row for the
    first visual id, and a polarity for every direction crop."""

    def get_labels_batch_boxes(self, enum_images, enum_boxes_lists):
        return [[{"id": "1", "class": "voltage.dc", "value": "12"}] for _ in enum_images]

    def get_directions_batch(self, crops, classes):
        return [("UP", "SIGN")] * len(crops)


@pytest.fixture(scope="module")
def pair(tiny_yolo):
    return _tiny_pair(tiny_yolo)


def _jax_batch(ja, images, finalize=False):
    """The JAX analyze_batch on `images` with the drawn boxes injected."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbatch.BatchedPipeline, "_detect_bboxes",
                   lambda self, chunk: [_boxes(JBBox, im.shape) for im in chunk])
        return ja.analyze_batch([copy.deepcopy(i) for i in images], mesh=_mesh1(),
                                batch_size=4, finalize=finalize)


@pytest.fixture(scope="module")
def reference(pair):
    ja, _ta = pair
    return {img.shape: r for img, r in zip([GOLDEN, LOOP], _jax_batch(ja, [GOLDEN, LOOP]))}


@pytest.fixture(autouse=True)
def _inject(monkeypatch):
    monkeypatch.setattr(tbatch.BatchedPipeline, "_detect_bboxes",
                        lambda self, chunk, imgs_dev: [_boxes(BBox, im.shape) for im in chunk])


@pytest.fixture()
def pipeline(pair):
    return tbatch.BatchedPipeline(pair[1], batch_size=4)


def test_results_match_jax_analyze_many(pipeline, reference):
    images = [GOLDEN, LOOP, GOLDEN]
    with BatchingExecutor(pipeline, max_wait_ms=50) as ex:
        served = ex.map([copy.deepcopy(i) for i in images])
    for img, got in zip(images, served):
        want = reference[img.shape]
        assert _summary(got) == _summary(want)
        assert (got.sam_mask == want.sam_mask).all()
        assert got.nodes and got.netlist_text


def test_concurrent_requests_coalesce(pipeline):
    """8 concurrent submits at batch_size=4 run in ≤ 3 batches, not 8."""
    with BatchingExecutor(pipeline, max_wait_ms=500) as ex:
        futs = [ex.submit(copy.deepcopy(LOOP)) for _ in range(8)]
        texts = {f.result(timeout=WAIT_S).netlist_text for f in futs}
        stats = ex.stats()
    assert len(texts) == 1
    assert stats["requests"] == stats["completed"] == 8
    assert stats["batches"] <= 3
    assert stats["mean_batch_size"] >= 8 / 3


@pytest.mark.parametrize("max_wait_ms", [10.0, 0.0])
def test_lone_request_is_served_alone(pipeline, max_wait_ms):
    """A lone request flushes on the deadline and its host stages run at
    once: while its device work is queued the worker takes only what is
    already queued, so it never waits for a second request."""
    with BatchingExecutor(pipeline, max_wait_ms=max_wait_ms) as ex:
        res = ex.submit(LOOP).result(timeout=WAIT_S)
        stats = ex.stats()
    assert res.netlist_text
    assert stats["batches"] == 1 and stats["completed"] == 1


def test_failed_batch_isolates(pipeline, monkeypatch):
    """An ordinary stage exception fails only its own batch's futures; the
    executor keeps serving."""
    real = tbatch.BatchedPipeline._detect_crop_phase
    calls = {"n": 0}

    def flaky(self, chunk):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected stage failure")
        return real(self, chunk)

    monkeypatch.setattr(tbatch.BatchedPipeline, "_detect_crop_phase", flaky)
    with BatchingExecutor(pipeline, max_wait_ms=10) as ex:
        bad = ex.submit(LOOP)
        with pytest.raises(RuntimeError, match="injected"):
            bad.result(timeout=WAIT_S)
        good = ex.submit(LOOP).result(timeout=WAIT_S)
        stats = ex.stats()
        assert ex.fault is None
    assert good.netlist_text
    assert stats["failed"] == 1 and stats["completed"] == 1


def test_submit_after_close_raises(pipeline):
    ex = BatchingExecutor(pipeline, max_wait_ms=10)
    ex.close()
    with pytest.raises(RuntimeError):
        ex.submit(LOOP)


def test_backlogged_queue_still_fills_batches(pipeline):
    """An aged first request still coalesces with already-queued ones: the
    deadline bounds waiting for requests that have NOT arrived."""
    ex = BatchingExecutor.__new__(BatchingExecutor)
    ex.pipeline = pipeline  # batch_size 4
    ex.max_wait_ms = 25.0
    ex._requests = queue.Queue()
    stale = time.perf_counter() - 1.0
    for _ in range(6):
        ex._requests.put(_Request(None, None, stale))
    assert len(ex._next_batch()) == 4
    assert ex._requests.qsize() == 2
    assert len(ex._next_batch(wait=False)) == 2
    assert ex._next_batch(wait=False) == []


def _serving(ex):
    server = make_server(ex, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, t, f"http://127.0.0.1:{server.server_address[1]}"


def _get(url):
    try:
        with HTTP.open(url, timeout=30) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _post(url, body):
    req = urllib.request.Request(f"{url}/analyze", data=body, method="POST")
    try:
        with HTTP.open(req, timeout=WAIT_S) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png(img):
    ok, buf = cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("where,fault", [
    ("_segment_phase", KernelError("refinement: CUDA error 719")),
    ("_host_stages", RuntimeError("CUDA error: an illegal memory access was encountered")),
])
def test_device_fault_breaks_the_executor(pipeline, monkeypatch, where, fault):
    """A device fault fails its batch, then every queued and later request
    with the same fault, and /healthz answers 503; an ordinary error would
    not (test_failed_batch_isolates)."""
    def boom(self, *a, **k):
        raise fault

    monkeypatch.setattr(tbatch.BatchedPipeline, where, boom)
    with BatchingExecutor(pipeline, max_wait_ms=10) as ex:
        server, t, url = _serving(ex)
        try:
            assert _get(f"{url}/healthz")[0] == 200
            with pytest.raises(type(fault)) as first:
                ex.submit(LOOP).result(timeout=WAIT_S)
            assert first.value is fault and ex.fault is fault
            later = [ex.submit(LOOP) for _ in range(3)]
            for f in later:
                assert f.exception(timeout=WAIT_S) is fault
            code, payload = _post(url, _png(LOOP))
            assert code == 500 and str(fault) in payload["error"]
            code, _h, body = _get(f"{url}/healthz")
            assert code == 503 and json.loads(body) == {
                "ok": False, "error": f"device fault: {fault}"}
            stats = ex.stats()
            assert stats["failed"] == 5 and stats["completed"] == 0
        finally:
            server.shutdown()
            t.join(timeout=30)


def test_http_roundtrip_stats_and_metrics(pipeline, reference):
    with BatchingExecutor(pipeline, max_wait_ms=10) as ex:
        server, t, url = _serving(ex)
        try:
            code, payload = _post(url, _png(LOOP))
            want = reference[LOOP.shape]
            assert code == 200
            assert payload["netlist_text"] == want.netlist_text
            assert payload["netlist_no_dir"] == want.valueless_netlist_text_no_vlm_dir
            assert payload["nodes"] == len(want.nodes)
            assert [(b["class"], b["xmin"], b["ymin"], b["xmax"], b["ymax"])
                    for b in payload["bboxes"]] == [
                (b.class_name, b.xmin, b.ymin, b.xmax, b.ymax) for b in want.bboxes_orig_nms]
            code, payload = _post(url, b"GIF89a not a png")
            assert code == 500 and "not a PNG" in payload["error"]
            assert _post(url, _png(GOLDEN))[1]["netlist_text"] == \
                reference[GOLDEN.shape].netlist_text

            assert _get(f"{url}/healthz")[:3:2] == (200, b'{"ok": true}')
            stats = json.loads(_get(f"{url}/stats")[2])
            assert stats["completed"] == 2 and stats["failed"] == 0
            assert stats["latency_s"]["p50"] is not None
            code, headers, body = _get(f"{url}/metrics")
            assert headers["Content-Type"].startswith("text/plain")
            text = body.decode()
            assert "# TYPE circuitvision_requests_total counter" in text
            assert "circuitvision_completed_total 2" in text
            assert "# TYPE circuitvision_request_latency_seconds summary" in text
            assert 'quantile="0.5"' in text
            assert _get(f"{url}/nope")[0] == 404
        finally:
            server.shutdown()
            t.join(timeout=30)


def test_jpeg_request_is_served_on_its_pixels(pipeline):
    """POST /analyze with a JPEG: the served netlist is the executor's on
    the pixels the port's reader decodes (PIL's, tests/test_torch_port_
    jpeg.py), and a BMP answers 500 naming ROADMAP Queue A 9."""
    ok, jpeg = cv2.imencode(".jpg", cv2.cvtColor(LOOP, cv2.COLOR_RGB2BGR),
                            [cv2.IMWRITE_JPEG_QUALITY, 95])
    assert ok
    pixels = decode_image(jpeg.tobytes())
    with BatchingExecutor(pipeline, max_wait_ms=10) as ex:
        server, t, url = _serving(ex)
        try:
            want = ex.submit(pixels).result(timeout=WAIT_S)
            code, payload = _post(url, jpeg.tobytes())
            assert code == 200 and payload["netlist_text"] == want.netlist_text
            ok, bmp = cv2.imencode(".bmp", LOOP)
            code, payload = _post(url, bmp.tobytes())
            assert code == 500 and "Queue A 9" in payload["error"]
        finally:
            server.shutdown()
            t.join(timeout=30)


def test_final_executor_merges_values(pair):
    """BatchingExecutor(final=True) runs the value pass per served batch:
    the served netlists carry the client's value and equal the JAX
    package's analyze_batch(finalize=True) with the same client."""
    ja, ta = pair
    ja.vlm_client = ta.vlm_client = BoxClient()
    try:
        imgs = [GOLDEN, LOOP, GOLDEN, LOOP]
        want = _jax_batch(ja, imgs, finalize=True)
        with BatchingExecutor(tbatch.BatchedPipeline(ta, batch_size=4), max_wait_ms=50.0,
                              final=True) as ex:
            served = ex.map([copy.deepcopy(i) for i in imgs])
    finally:
        ja.vlm_client = ta.vlm_client = None
    for got, ref in zip(served, want):
        assert _summary(got) == _summary(ref)
        assert got.vlm_stage2_output == ref.vlm_stage2_output
        assert " 12" in got.netlist_text


def test_sigterm_drains_and_exits_zero(tmp_path):
    """SIGTERM to `python -m circuitvision_tpu_torch.cli serve-batch`
    (tiny seeded YOLO on the CPU, an ephemeral port) exits 0 through the
    drain path, not the default kill."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "circuitvision_tpu_torch.cli", "serve-batch", "--device", "cpu",
         "--port", "0", "--scale", "n", "--det-size", "64", "--max-wait-ms", "10"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env={**os.environ, "CIRCUITVISION_VLM": ""})
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on port "), line
        url = f"http://127.0.0.1:{int(line.split()[3])}"
        assert _get(f"{url}/healthz")[0] == 200
        assert _post(url, _png(LOOP))[0] == 200
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0
    assert "in-flight batches drained" in out
