"""The black-box VLM value pass of the PyTorch port against the JAX
package on the CPU:

  * the prompts and the two reply parsers (results and error messages,
    fenced, python-literal, null, bare and garbage replies, and a
    hypothesis sweep);
  * the Gemini client's generateContent requests against the ones the
    JAX client sends through google-genai 1.62.0 to the same stub server
    on 127.0.0.1 (JSON equal, the inline PNG compared as pixels), and
    its replies parsed alike, failures included; the OpenRouter request
    against the message list the JAX client hands the openai SDK (a
    stand-in module takes the SDK's place, so openai need not be
    installed);
  * default_client's branches;
  * enumerate_components byte-equal to the JAX package's cv2 drawing, with
    equal visual-id boxes: the 63 eval images with their ground-truth
    boxes, one drawing in every digit render class of heights 1-4096,
    crowded pages that leave only the fallbacks, a drawing at 4097 rows
    and the named error above 65500;
  * the per-crop direction pool with a client that fails on some crops;
  * the Gemini and OpenRouter clients through the analyzer at the
    shipped checkpoints against the stub, netlists equal to a fake
    client's with the same answers, and the web UI, the serving executor
    and the CLI with a whole-image client. (The fake client's final
    netlists against the JAX package are in test_torch_port_product.py,
    on its analyzers.)
"""
import base64
import dataclasses
import http.server
import json
import re
import sys
import threading
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chip_smoke import replayed_directions  # the card's stub answers by prompt kind
from circuitvision_tpu.core.config import EnrichConfig as JEnrich
from circuitvision_tpu.core.types import BBox as JBox
from circuitvision_tpu.enrich import client as jclient
from circuitvision_tpu.enrich import directions as jdirections
from circuitvision_tpu.enrich import prompts as jprompts
from circuitvision_tpu.topology import enumerate_components as jenum
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.core import rubik_digits
from circuitvision_tpu_torch.core.types import BBox
from circuitvision_tpu_torch.enrich import client as tclient
from circuitvision_tpu_torch.enrich import directions as tdirections
from circuitvision_tpu_torch.enrich import prompts as tprompts
from circuitvision_tpu_torch.io.image_io import decode_image, load_image
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.models.checkpoint import load_model_checkpoint
from circuitvision_tpu_torch.ops.cuda.build import KernelError
from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch
from circuitvision_tpu_torch.topology import enumerate_components as tenum

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "eval_data"
NAMES = sorted(p.stem for p in (DATA / "images").glob("*.png"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's tests, restored after: the
    suite runs six workers on eight cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _labels(name):
    return json.loads((DATA / "labels" / f"{name}.json").read_text())


def _boxes(name, box_type=BBox):
    rows = json.loads((DATA / "boxes" / f"{name}.json").read_text())
    return [box_type.from_dict(d) for d in rows]


# ------------------------------------------------------------------ stub server
class Stub:
    """An HTTP server on 127.0.0.1 that records each POST (path, headers,
    JSON body) and answers with `reply(path, body) -> (status, JSON)`."""

    def __init__(self):
        self.requests: list = []
        self.reply = lambda path, body: (500, {"error": "no reply set"})
        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            disable_nagle_algorithm = True

            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                stub.requests.append((self.path, {k.lower(): v for k, v in self.headers.items()},
                                      body))
                status, out = stub.reply(self.path, body)
                data = json.dumps(out).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def take(self):
        out, self.requests = self.requests, []
        return out


@pytest.fixture(scope="module")
def stub():
    s = Stub()
    yield s
    s.server.shutdown()
    s.server.server_close()


def _pixels(b64: str, decode=base64.b64decode):
    img = decode_image(decode(b64))
    return img.shape, img.tobytes()


def _normalised(body):
    """The request JSON with every inline PNG replaced by its pixels
    (Gemini's inlineData in the URL-safe base64 google-genai sends)."""
    if isinstance(body, dict):
        if set(body) == {"data", "mimeType"}:
            return {"mimeType": body["mimeType"],
                    "pixels": _pixels(body["data"], base64.urlsafe_b64decode)}
        if set(body) == {"url"} and body["url"].startswith("data:image/png;base64,"):
            return {"pixels": _pixels(body["url"].split(",", 1)[1])}
        return {k: _normalised(v) for k, v in body.items()}
    if isinstance(body, list):
        return [_normalised(v) for v in body]
    return body


def _outcome(fn, *args):
    """("ok", result) or ("raises", message) — a message with an object's
    address (ast's "<ast.Name object at 0x...>") compared without it."""
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # the JAX SDK's HTTP errors and the port's differ in type
        if not isinstance(exc, (ValueError, AttributeError)):
            return ("raises", "http error")
        return ("raises", re.sub(r" at 0x[0-9a-f]+>", ">", exc.args[0]))


def _gemini_pair(stub):
    from google import genai

    jc = jclient.GeminiVLMClient(api_key="k")
    jc.client = genai.Client(api_key="k", http_options={"base_url": stub.url})
    return jc, tclient.GeminiVLMClient(api_key="k", endpoint=stub.url)


def _gemini_reply(text):
    return 200, {"candidates": [{"content": {"parts": [{"text": text}], "role": "model"},
                                 "finishReason": "STOP"}]}


# -------------------------------------------------------------- prompts, parsers
def test_prompts_equal_jax():
    for name in ("COMPONENTS_DICT", "LABELS_PROMPT", "VOLTAGE_DIRECTION_PROMPT",
                 "DIODE_DIRECTION_PROMPT"):
        assert getattr(tprompts, name) == getattr(jprompts, name), name


REPLIES = [
    '```json\n[{"id": "1", "class": "resistor", "value": "10k"}]\n```',
    "```python\n[{'id': '1', 'class': 'gnd', 'value': None}]\n```",
    '[{"id": "2", "class": "capacitor", "value": null}]',
    "[{'id': '3', 'class': 'voltage.ac', 'value': '4:-45'}]",
    '```json\\n[{"id": "1", "class": "inductor", "value": "1m"}]\\n```',
    "nothing to see here",
    "",
    "```",
    "[{'id': 1, 'value': }]",
    '{"id": "1"}',
]


@pytest.mark.parametrize("text", REPLIES)
@pytest.mark.parametrize("parser", ["parse_vlm_list", "parse_gemini_labels"])
def test_parsers_equal_jax(parser, text):
    assert _outcome(getattr(tclient, parser), text) == _outcome(getattr(jclient, parser), text)


@settings(max_examples=300, deadline=None)
@given(st.text(alphabet="`pythonjs\\n\n []{}:,'\"0123456789nulNoe-.", max_size=40))
def test_parsers_equal_jax_on_any_reply(text):
    for parser in ("parse_vlm_list", "parse_gemini_labels"):
        assert _outcome(getattr(tclient, parser), text) == \
            _outcome(getattr(jclient, parser), text), parser


# ----------------------------------------------------------------- the clients
LABEL_REPLIES = {
    "fenced": _gemini_reply('```json\n[{"id": "1", "class": "resistor", "value": "5"}]\n```'),
    "python": _gemini_reply("[{'id': '1', 'class': 'gnd', 'value': null}]"),
    "garbage": _gemini_reply("I cannot read this image."),
    "thought": (200, {"candidates": [{"content": {"parts": [
        {"text": "thinking...", "thought": True}, {"text": '[{"id": "2"'},
        {"text": ', "value": "3"}]'}]}}]}),
    "no candidates": (200, {"candidates": []}),
    "server error": (500, {"error": {"code": 500, "message": "boom", "status": "INTERNAL"}}),
}


@pytest.mark.parametrize("kind", sorted(LABEL_REPLIES))
def test_gemini_labels_request_equals_jax(stub, kind):
    """The labels call: the same path, key header and JSON (image, "\\n",
    LABELS_PROMPT, temperature 0) as google-genai sends for the JAX
    client, on the enumeration image of an eval drawing; the reply read
    alike."""
    jc, tc = _gemini_pair(stub)
    img, _ = tenum.enumerate_components(load_image(str(DATA / "images" / "ac_rc.png")),
                                        _boxes("ac_rc"))
    stub.reply = lambda path, body: LABEL_REPLIES[kind]
    want = _outcome(jc.get_labels, img)
    (jpath, jhead, jbody), = stub.take()
    got = _outcome(tc.get_labels, img)
    (tpath, thead, tbody), = stub.take()
    assert got == want
    assert tpath == jpath == "/v1beta/models/gemini-2.5-pro-exp-03-25:generateContent"
    assert thead["x-goog-api-key"] == jhead["x-goog-api-key"] == "k"
    assert _normalised(tbody) == _normalised(jbody)
    assert list(tbody) == list(jbody)
    assert _normalised(tbody)["contents"][0]["parts"][0]["inlineData"]["pixels"] == \
        (img.shape, img.tobytes())


DIRECTION_REPLIES = {
    "answer": _gemini_reply('{"symbol_positions": "x", "direction": "up", "reason": "sign"}'),
    "no reason": _gemini_reply('{"direction": "left"}'),
    "no direction": _gemini_reply('{"reason": "ARROW"}'),
    "not json": _gemini_reply("UP"),
    "server error": (500, {"error": {"code": 500, "message": "boom", "status": "INTERNAL"}}),
}


@pytest.mark.parametrize("cls", ["voltage.dc", "diode.zener", "resistor"])
@pytest.mark.parametrize("kind", sorted(DIRECTION_REPLIES))
def test_gemini_direction_request_equals_jax(stub, kind, cls):
    """The direction call: [prompt, crop] with JSON mime type,
    temperature, top_p and max_output_tokens; a class without a
    direction sends nothing; a failure reads UNKNOWN."""
    jc, tc = _gemini_pair(stub)
    for c in (jc, tc):
        c.temperature, c.top_p, c.max_output_tokens = 0.3, 0.5, 77
    crop = np.random.default_rng(7).integers(0, 256, (23, 31, 3), dtype=np.uint8)
    stub.reply = lambda path, body: DIRECTION_REPLIES[kind]
    want = jc.get_direction(crop, cls)
    jreq = stub.take()
    got = tc.get_direction(crop, cls)
    treq = stub.take()
    assert got == want
    assert len(jreq) == len(treq) == (0 if cls == "resistor" else 1)
    for (jp, jh, jb), (tp, th, tb) in zip(jreq, treq):
        assert tp == jp == "/v1beta/models/gemini-2.5-flash-lite-preview-06-17:generateContent"
        assert th["x-goog-api-key"] == jh["x-goog-api-key"]
        assert _normalised(tb) == _normalised(jb)
        assert tb["generationConfig"] == {"temperature": 0.3, "topP": 0.5,
                                          "maxOutputTokens": 77,
                                          "responseMimeType": "application/json"}


class _OpenAIStandIn:
    """What the JAX OpenRouterVLMClient sees of the openai SDK: records
    each chat.completions.create call and answers `content`."""

    def __init__(self, base_url, api_key):
        self.base_url, self.api_key, self.calls, self.content = base_url, api_key, [], None
        self.chat = types.SimpleNamespace(completions=types.SimpleNamespace(create=self.create))

    def create(self, **kwargs):
        self.calls.append(kwargs)
        choices = [] if self.content is None else [types.SimpleNamespace(
            message=types.SimpleNamespace(content=self.content))]
        return types.SimpleNamespace(choices=choices)


@pytest.mark.parametrize("content", [
    "```python\n[{'id': '1', 'class': 'resistor', 'value': '10'}]\n```",
    '```json\n[{"id": "2", "class": "gnd", "value": null}]\n```',
    "no list here", None])
def test_openrouter_request_holds_jax_messages(stub, monkeypatch, content):
    monkeypatch.setitem(sys.modules, "openai", types.SimpleNamespace(OpenAI=_OpenAIStandIn))
    jc = jclient.OpenRouterVLMClient(api_key="k", model="m/x")
    jc.client.content = content
    tc = tclient.OpenRouterVLMClient(api_key="k", model="m/x", endpoint=stub.url + "/api/v1")
    img, _ = tenum.enumerate_components(load_image(str(DATA / "images" / "series_rl.png")),
                                        _boxes("series_rl"))
    stub.reply = lambda path, body: (200, {"choices": [] if content is None else [
        {"index": 0, "message": {"role": "assistant", "content": content}}]})
    want = _outcome(jc.get_labels, img)
    got = _outcome(tc.get_labels, img)
    (path, head, body), = stub.take()
    assert got == want
    assert path == "/api/v1/chat/completions" and head["authorization"] == "Bearer k"
    assert jc.client.base_url == tclient.OPENROUTER_ENDPOINT and jc.client.api_key == "k"
    call, = jc.client.calls
    assert _normalised(body) == _normalised(call)
    image_url = body["messages"][0]["content"][1]["image_url"]["url"]
    assert _pixels(image_url.split(",", 1)[1]) == (img.shape, img.tobytes())
    assert tc.get_direction(img, "voltage.dc") == jc.get_direction(img, "voltage.dc")
    assert stub.take() == []


def test_default_client_branches(monkeypatch, tmp_path):
    """reader: loads the crop reader; paligemma: with no checkpoint raises; a Gemini key
    gives the Gemini client with EnrichConfig's direction model and
    generation parameters (JAX :300-311), an OpenRouter key the
    OpenRouter client with its labels model (:312-318); Gemini first."""
    from circuitvision_tpu_torch.enrich.trained_reader import TrainedReaderClient

    for k in ("CIRCUITVISION_VLM", "GEMINI_API_KEY", "OPENROUTER_API_KEY"):
        monkeypatch.delenv(k, raising=False)
    enrich = tconfig.EnrichConfig(direction_model="d", labels_model="l", temperature=0.5,
                                  top_p=0.7, max_output_tokens=9)
    assert tclient.default_client(enrich, device="cpu") is None
    monkeypatch.setenv("CIRCUITVISION_VLM", f"reader:{ROOT / 'ckpt' / 'reader'}")
    assert isinstance(tclient.default_client(enrich, device="cpu"), TrainedReaderClient)
    monkeypatch.setenv("CIRCUITVISION_VLM", "paligemma:/x")  # no checkpoint there
    with pytest.raises(FileNotFoundError):
        tclient.default_client(enrich, device="cpu")
    monkeypatch.delenv("CIRCUITVISION_VLM")
    monkeypatch.setenv("OPENROUTER_API_KEY", "ok")
    c = tclient.default_client(enrich, device="cpu")
    assert isinstance(c, tclient.OpenRouterVLMClient) and (c.model, c.api_key) == ("l", "ok")
    assert tclient.default_client(device="cpu").model == "google/gemini-2.5-flash-preview"
    monkeypatch.setenv("GEMINI_API_KEY", "gk")
    jc = jclient.default_client(JEnrich(direction_model="d", labels_model="l", temperature=0.5,
                                        top_p=0.7, max_output_tokens=9))
    for c, j in ((tclient.default_client(enrich, device="cpu"), jc),
                 (tclient.default_client(device="cpu"), jclient.default_client())):
        assert isinstance(c, tclient.GeminiVLMClient)
        for attr in ("api_key", "labels_model", "direction_model", "temperature", "top_p",
                     "max_output_tokens"):
            assert getattr(c, attr) == getattr(j, attr), attr
        assert c.endpoint == tclient.GEMINI_ENDPOINT


# ------------------------------------------------------------- the enumeration
def _enum_pair(img, boxes):
    j_img, j_boxes = jenum.enumerate_components(img, [JBox.from_dict(b.to_dict()) for b in boxes])
    t_img, t_boxes = tenum.enumerate_components(img, boxes)
    assert t_img.tobytes() == j_img.tobytes()
    assert [b.to_dict() for b in t_boxes] == [b.to_dict() for b in j_boxes]
    return t_img, t_boxes


@pytest.mark.parametrize("name", NAMES)
def test_enumeration_equals_jax_on_eval_images(name):
    img = load_image(str(DATA / "images" / f"{name}.png"))
    drawn, boxes = _enum_pair(img, _boxes(name))
    assert not np.shares_memory(drawn, img)
    assert [b.visual_id for b in boxes] == list(range(1, len(boxes) + 1))


def _sizes(rows):
    return max(0.4, rows / 900.0), int(max(1, rows / 600.0))


def _class_heights():
    """The first image height up to 4096 rows whose digits, or their halo,
    draw in each render class (pixel size, bold) of core/rubik_digits.py."""
    first = {}
    for rows in range(1, 4097):
        scale, t = _sizes(rows)
        for tt in (t, t + 2):
            first.setdefault(rubik_digits.render_class(scale, tt), rows)
    return first


CLASS_HEIGHTS = _class_heights()


def test_every_render_class_is_drawn():
    """Heights 1-4096 draw 139 classes: pixel sizes 11-123 bold, and
    11-36 regular (thickness 1, up to 1199 rows)."""
    assert set(CLASS_HEIGHTS) == ({(s, True) for s in range(11, 124)}
                                  | {(s, False) for s in range(11, 37)})
    assert len(CLASS_HEIGHTS) == 139


@pytest.mark.parametrize("key", sorted(CLASS_HEIGHTS),
                         ids=lambda k: f"{k[0]}{'b' if k[1] else 'r'}")
def test_enumeration_equals_jax_in_every_render_class(key):
    """A page in each class: twelve components (ids 10-12 have two
    digits), a text box, on wires, ids near every edge."""
    rows = CLASS_HEIGHTS[key]
    rng = np.random.default_rng(rows)
    cols = max(60, min(900, rows))
    img = np.full((rows, cols, 3), 255, np.uint8)
    img[rows // 2, :] = 0
    img[:, cols // 3] = 0
    boxes = [BBox("text", 1.0, cols // 2, 0, cols // 2 + cols // 8, max(1, rows // 10))]
    for i in range(12):
        bw, bh = int(rng.integers(2, max(3, cols // 5))), int(rng.integers(1, max(2, rows // 5)))
        x0, y0 = int(rng.integers(0, max(1, cols - bw))), int(rng.integers(0, max(1, rows - bh)))
        boxes.append(BBox(("resistor", "voltage.dc", "gnd")[i % 3], 0.9, x0, y0, x0 + bw, y0 + bh))
    _enum_pair(img, boxes)


@pytest.mark.parametrize("rows", [300, 1300])
def test_crowded_page_takes_both_fallbacks(rows, monkeypatch):
    """Components tiling the whole page leave no candidate position free
    (math.hypot, the distance of a permissible one, is never called):
    each id takes the fallback above its component's top left, and the
    top row, whose ids would overlap their components, the second
    fallback down the page's left edge."""
    cols = 640
    img = np.full((rows, cols, 3), 200, np.uint8)
    bw, bh = cols // 8, rows // 6
    boxes = [BBox("resistor", 1.0, x, y, x + bw, y + bh)
             for y in range(0, rows - bh + 1, bh) for x in range(0, cols - bw + 1, bw)]
    boxes.insert(5, BBox("text", 1.0, 3, 3, 40, 20))
    calls = []
    monkeypatch.setattr(tenum, "math", types.SimpleNamespace(
        hypot=lambda *a: calls.append(a) or 0.0))
    _enum_pair(img, boxes)
    assert calls == []
    th = tenum.draw.get_text_size("1", *_sizes(rows))[0][1]
    assert boxes[0].ymin - th - 3 < 0 <= boxes[-1].ymin - th - 3


def test_enumeration_refuses_images_past_the_table():
    """The digits draw past the 4096 rows the old glyph table held, as the
    JAX package draws them, up to the 65500 rows they were checked at;
    one row more raises the named error."""
    box = BBox("resistor", 1.0, 1, 1, 4, 4)
    img = np.full((4097, 40, 3), 255, np.uint8)
    drawn, boxes = _enum_pair(img, [box])
    assert boxes[0].visual_id == 1 and drawn.shape == (4097, 40, 3)
    assert (drawn != img).any()
    assert rubik_digits.MAX_ROWS == 65500
    with pytest.raises(tenum.EnumerationSizeError, match="up to 65500 rows .* has 65501"):
        tenum.enumerate_components(np.zeros((65501, 8, 3), np.uint8), [box])


# ----------------------------------------------------------- the direction pool
class _Flaky:
    """Reads a direction from the crop's shape, fails on some crops, and
    records the most calls that were in flight at once."""

    def __init__(self, exc=RuntimeError("timed out")):
        self.exc, self.calls, self.in_flight, self.most_in_flight = exc, 0, 0, 0
        self.lock = threading.Lock()

    def get_labels(self, img):
        return []

    def get_direction(self, crop, cls):
        with self.lock:
            self.calls += 1
            self.in_flight += 1
            self.most_in_flight = max(self.most_in_flight, self.in_flight)
        try:
            time.sleep(0.001)  # hold the call open so that overlapping calls overlap
            if crop.shape[1] % 3 == 0:
                raise self.exc
            return ("UP", "SIGN") if crop.shape[0] % 2 else ("LEFT", cls.upper())
        finally:
            with self.lock:
                self.in_flight -= 1


def _direction_page(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    classes = ("voltage.dc", "voltage.ac", "diode", "resistor", "current.dc", "diode.zener")
    boxes = []
    for i in range(18):
        x0, y0 = (int(v) for v in rng.integers(-10, 380, 2))
        w, h = (int(v) for v in rng.integers(1, 40, 2))
        boxes.append(BBox(classes[i % len(classes)], 0.9, x0, y0, x0 + w, y0 + h))
    return img, boxes


def _dirs(boxes):
    return [(b.class_name, b.semantic_direction, b.semantic_reason) for b in boxes]


def test_per_crop_direction_pool_equals_jax():
    pages = [_direction_page(s) for s in (1, 2, 3)]
    for workers in (1, 3, 8):
        cfg, jcfg = tconfig.EnrichConfig(max_concurrency=workers), JEnrich(max_concurrency=workers)
        client = _Flaky()
        got = tdirections.enrich_directions_many([p[0] for p in pages], [p[1] for p in pages],
                                                 client, cfg)
        want = [jdirections.enrich_directions(img, [JBox.from_dict(b.to_dict()) for b in bx],
                                              _Flaky(), jcfg) for img, bx in pages]
        assert [_dirs(g) for g in got] == [_dirs(w) for w in want]
        assert 1 <= client.most_in_flight <= workers
        one = tdirections.enrich_directions(pages[0][0], pages[0][1], _Flaky(), cfg)
        assert _dirs(one) == _dirs(want[0])
    assert {d for g in got for _c, d, _r in _dirs(g)} >= {"UP", "LEFT", "UNKNOWN", None}


def test_per_crop_pool_reraises_device_faults():
    img, boxes = _direction_page(4)
    with pytest.raises(KernelError):
        tdirections.enrich_directions(img, boxes, _Flaky(KernelError("launch failed")))


# -------------------------------------------------- the analyzer with whole images
@pytest.fixture(scope="module")
def port_analyzer():
    """The trained product's YOLO and SAM2 in float32 on the CPU (the JAX
    comparisons of this path are in test_torch_port_product.py)."""
    yv, ymeta = load_model_checkpoint(str(ROOT / "ckpt" / "yolo"))
    sv, smeta = load_model_checkpoint(str(ROOT / "ckpt" / "sam2"))
    tcfg = tconfig.PipelineConfig(
        detector=dataclasses.replace(bridge.detector_config(ymeta), dtype="float32"),
        sam2=bridge.sam2_config(smeta, dtype="float32"))
    return CircuitAnalyzerTorch(tcfg, bridge.state_dict_from_variables(yv),
                                bridge.state_dict_from_variables(sv), device="cpu",
                                vlm_client=tclient.FakeVLMClient())


def test_http_clients_through_the_analyzer_equal_the_fake(port_analyzer, stub):
    """The Gemini client (labels and directions) and the OpenRouter
    client (labels; its directions read UNKNOWN) pointed at the stub,
    which answers from an eval label file: the final netlists equal a
    fake client's with the same answers, and the PNG the stub received
    is the drawn enumeration image."""
    ta = port_analyzer
    name = "ac_rc"
    canned = _labels(name)
    answers, fake_directions = replayed_directions(canned)
    path = str(DATA / "images" / f"{name}.png")

    def reply(path_, body):
        if path_.endswith("chat/completions"):
            return 200, {"choices": [{"message": {"content": json.dumps(canned["labels"])}}]}
        parts = body["contents"][0]["parts"]
        if parts[-1] == {"text": tprompts.LABELS_PROMPT}:
            return _gemini_reply(json.dumps(canned["labels"]))
        kind = "voltage" if parts[0]["text"] == tprompts.VOLTAGE_DIRECTION_PROMPT else "diode"
        direction, reason = answers[kind]
        return _gemini_reply(json.dumps({"direction": direction, "reason": reason}))

    stub.reply = reply
    stub.take()
    for client, directions in (
            (tclient.GeminiVLMClient(api_key="k", endpoint=stub.url), True),
            (tclient.OpenRouterVLMClient(api_key="k", endpoint=stub.url), False)):
        ta.vlm_client = tclient.FakeVLMClient(canned["labels"],
                                              fake_directions if directions else {})
        want = ta.generate_final_netlist(ta.analyze(load_image(path)))
        stub.take()
        ta.vlm_client = client
        got = ta.generate_final_netlist(ta.analyze(load_image(path)))
        requests = stub.take()
        labels = [b for p, _h, b in requests
                  if p.endswith("chat/completions") or "gemini-2.5-pro" in p]
        assert len(labels) == 1
        sent = (_pixels(labels[0]["messages"][0]["content"][1]["image_url"]["url"].split(",")[1])
                if "messages" in labels[0] else
                _pixels(labels[0]["contents"][0]["parts"][0]["inlineData"]["data"],
                        base64.urlsafe_b64decode))
        assert sent == (got.enum_image.shape, got.enum_image.tobytes())
        assert got.enum_image.tobytes() == want.enum_image.tobytes()
        assert got.netlist_text == want.netlist_text
        assert _dirs(got.bboxes) == _dirs(want.bboxes)
        assert got.vlm_stage2_output == want.vlm_stage2_output
        assert len(requests) == 1 + directions * sum(
            b.class_name in fake_directions for b in got.bboxes)


def test_surfaces_run_with_a_whole_image_client(port_analyzer, monkeypatch, capsys):
    """The web UI (POST /analyze, its direction panel and enumeration
    image, then /final), the serving executor with final=True and the
    CLI's `analyze --final` with a FakeVLMClient: each gives the final
    netlist of analyze() + generate_final_netlist."""
    import urllib.request

    from circuitvision_tpu_torch import cli, webapp
    from circuitvision_tpu_torch.io.image_io import encode_png
    from circuitvision_tpu_torch.pipeline import analyzer as tanalyzer
    from circuitvision_tpu_torch.pipeline.batch import BatchedPipeline
    from circuitvision_tpu_torch.pipeline.server import BatchingExecutor

    ta = port_analyzer
    name = "ac_rc"
    path = DATA / "images" / f"{name}.png"
    canned = _labels(name)
    directions = replayed_directions(canned)[1]
    ta.vlm_client = tclient.FakeVLMClient(canned["labels"], directions)
    img = load_image(str(path))
    want = ta.generate_final_netlist(ta.analyze(img))
    assert want.vlm_direction_crops and want.netlist_text != want.valueless_netlist_text

    server = webapp.make_server(ta, port=0, host="127.0.0.1")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(route, data):
        with opener.open(urllib.request.Request(url + route, data=data, method="POST"),
                         timeout=600) as resp:
            return json.loads(resp.read())

    try:
        out = post("/analyze", encode_png(img))
        assert out["enum_img"] == webapp._png_b64(want.enum_image)
        assert {c["class"] for c in out["vlm_crops"]} == {
            b.class_name for b in want.bboxes if b.persistent_uid in want.vlm_direction_crops}
        assert post("/final", b"")["netlist_text"] == want.netlist_text
    finally:
        server.shutdown()
        server.server_close()

    with BatchingExecutor(BatchedPipeline(ta, batch_size=2), final=True) as ex:
        assert ex.map([img])[0].netlist_text == want.netlist_text

    fakes, built = [], []
    monkeypatch.setattr(tanalyzer, "default_client", lambda enrich, device: fakes.append(
        tclient.FakeVLMClient(canned["labels"], directions)) or fakes[-1])
    monkeypatch.setattr(cli, "_analyzer", lambda args, make=cli._analyzer: built.append(
        make(args)) or built[-1])
    capsys.readouterr()
    assert cli.main(["analyze", str(path), "--final", "--device", "cpu",
                     "--yolo-checkpoint", str(ROOT / "ckpt" / "yolo"),
                     "--sam2-checkpoint", str(ROOT / "ckpt" / "sam2")]) == 0
    printed = capsys.readouterr().out
    netlist = printed.split("=== netlist ===\n", 1)[1].split("=== timings ===", 1)[0]
    # the CLI's analyzer (its detector in the shipped bfloat16) with the
    # fake: its value pass ran, and the CLI printed its final netlist
    assert fakes[0].label_calls == 1 and fakes[0].direction_calls
    cli_analyzer, = built
    again = cli_analyzer.generate_final_netlist(cli_analyzer.analyze(img))
    assert netlist == (again.netlist_text or "(empty)") + "\n"
