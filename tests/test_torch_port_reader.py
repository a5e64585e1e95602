"""The port's trained crop reader (models/reader.py), its client
(enrich/trained_reader.py), direction enrichment, the client the
environment names, the device-fault test of the ladders, and fix_netlist against the JAX package on the CPU, float32, with the
shipped ckpt/reader (read by the port's own checkpoint reader on the
port's side and by orbax on the JAX side)."""
import dataclasses
import json
import logging
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitvision_tpu.core.types import BBox as JBox
from circuitvision_tpu.core.types import NetlistLine as JLine
from circuitvision_tpu.enrich import directions as jdirections
from circuitvision_tpu.enrich.trained_reader import load_trained_reader as jax_reader
from circuitvision_tpu.io.image_io import load_image
from circuitvision_tpu.models.checkpoint import load_variables as jax_load_variables
from circuitvision_tpu.netlist.fix import fix_netlist as jax_fix
from circuitvision_tpu.train import reader as jreader
from circuitvision_tpu_torch.core.config import EnrichConfig
from circuitvision_tpu_torch.core.types import BBox, NetlistLine
from circuitvision_tpu_torch.enrich import client as tclient
from circuitvision_tpu_torch.enrich import directions as tdirections
from circuitvision_tpu_torch.enrich.trained_reader import TrainedReaderClient, load_trained_reader
from circuitvision_tpu_torch.models import reader as treader
from circuitvision_tpu_torch.models.bridge import state_dict_from_variables
from circuitvision_tpu_torch.models.checkpoint import load_variables
from circuitvision_tpu_torch.netlist.fix import fix_netlist
from circuitvision_tpu_torch.ops.cuda.build import KernelError, is_device_fault
from circuitvision_tpu_torch.topology.enumerate_components import assign_visual_ids

ROOT = Path(__file__).resolve().parents[1]
READER = str(ROOT / "ckpt" / "reader")
#: eval images whose ground-truth boxes give the real value windows
REAL = ("ac_rc", "series_rl", "hand_0")


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def readers():
    return jax_reader(READER), load_trained_reader(READER, device="cpu")


def _image(name):
    return load_image(str(ROOT / "eval_data" / "images" / f"{name}.png"))


def _gt(name, box_type=BBox):
    rows = json.loads((ROOT / "eval_data" / "boxes" / f"{name}.json").read_text())
    return [box_type(r["class"], r["confidence"], r["xmin"], r["ymin"], r["xmax"], r["ymax"])
            for r in rows]


def _crops():
    """Seeded 160² crops (noise, and mostly-white noise as schematics
    are) and the centred value windows of three eval images' boxes."""
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (8, 160, 160, 3), dtype=np.uint8)
    noise[4:] = np.where(rng.random((4, 160, 160, 1)) < 0.9, 255, noise[4:])
    windows = [jreader.make_value_window(_image(n), b) for n in REAL for b in _gt(n, JBox)]
    return np.concatenate([noise, np.stack(windows)])


def test_crop_reader_logits_match_jax():
    """The three heads on the same crops: within 1e-4 × max(1, max |ref|)
    (the two differ in summation order only), and every argmax equal."""
    crops = _crops()
    assert len(crops) > 20
    ref = jreader.CropReader().apply(jax_load_variables(READER),
                                     jnp.asarray(crops, jnp.float32) / 255.0)
    model = treader.CropReader()
    model.load_state_dict(state_dict_from_variables(load_variables(READER)), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(crops))
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= 1e-4 * max(1.0, float(np.abs(r).max()))
        np.testing.assert_array_equal(g.argmax(-1), r.argmax(-1))


@pytest.mark.parametrize("shape", [(40, 60, 3), (63, 160, 3), (90, 120, 3), (160, 160, 3),
                                   (200, 170, 3), (320, 320, 3), (413, 97, 3), (75, 75)])
def test_resize_crop_equals_cv2(shape):
    """Up, down, identity and exact 2× (OpenCV's area path), RGB and grey."""
    crop = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    ref = cv2.resize(crop, (160, 160), interpolation=cv2.INTER_LINEAR)
    got = treader.resize_crop(crop, 160)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


#: inside, touching each border, past the corners, outside, degenerate
BOXES = [(100, 80, 160, 120), (0, 0, 30, 40), (250, 180, 300, 200), (-20, -10, 15, 12),
         (280, 190, 340, 260), (400, 300, 450, 350), (50, 50, 50, 90)]


@pytest.mark.parametrize("xyxy", BOXES)
def test_crop_makers_equal_jax(xyxy):
    image = np.random.default_rng(1).integers(0, 256, (200, 300, 3), dtype=np.uint8)
    tb, jb = BBox("resistor", 1.0, *xyxy), JBox("resistor", 1.0, *xyxy)
    np.testing.assert_array_equal(treader.make_value_window(image, tb),
                                  jreader.make_value_window(image, jb))
    np.testing.assert_array_equal(treader.make_value_window(image, tb, jitter=(5, -7)),
                                  jreader.make_value_window(image, jb, jitter=(5, -7)))
    for pad in (treader.CROP_PAD, 15):
        np.testing.assert_array_equal(treader.make_crop(image, tb, pad=pad),
                                      jreader.make_crop(image, jb, pad=pad))


def test_value_codes_equal_jax():
    assert treader.READER_CLASS_NAMES == jreader.READER_CLASS_NAMES
    assert dataclasses.asdict(treader.ReaderConfig()) == dataclasses.asdict(jreader.ReaderConfig())
    for v in (None, "", "10k", "4:-45", "1u63", "abcdefghij", "2.2M"):
        np.testing.assert_array_equal(treader.encode_value(v), jreader.encode_value(v))
        assert treader.decode_value(treader.encode_value(v)) == \
            jreader.decode_value(jreader.encode_value(v))


def _enum_jobs(box_type, repeat):
    """Eval images and their id'd ground-truth boxes, each image `repeat`
    times: the stage-2 input of get_labels_batch_boxes."""
    images, boxes = [], []
    for n in REAL:
        img = _image(n)
        ids = assign_visual_ids(_gt(n, BBox))
        ided = [box_type(b.class_name, b.confidence, b.xmin, b.ymin, b.xmax, b.ymax,
                         visual_id=b.visual_id) for b in ids]
        images += [img] * repeat
        boxes += [ided] * repeat
    return images, boxes


@pytest.mark.parametrize("repeat", [1, 25])
def test_labels_batch_boxes_equal_jax(readers, repeat):
    """The stage-2 rows of every image; at repeat 25 over 256 jobs, which
    both clients read as 256-crop sub-batches."""
    jr, tr = readers
    j_images, j_boxes = _enum_jobs(JBox, repeat)
    t_images, t_boxes = _enum_jobs(BBox, repeat)
    jobs = sum(len(b) for b in t_boxes)
    assert (jobs > 256) == (repeat > 1)
    assert tr.get_labels_batch_boxes(t_images, t_boxes) == \
        jr.get_labels_batch_boxes(j_images, j_boxes)


def test_directions_batch_equal_jax(readers):
    """The direction reads of every eval component crop of three images,
    padded as stage [4] pads them and resized as cv2 resizes."""
    jr, tr = readers
    crops, classes = [], []
    for n in REAL:
        img = _image(n)
        for b in _gt(n, JBox):
            crops.append(img[max(0, b.ymin - 15):b.ymax + 15, max(0, b.xmin - 15):b.xmax + 15])
            classes.append(b.class_name)
    got = tr.get_directions_batch(crops, classes)
    assert got == jr.get_directions_batch(crops, classes)
    assert {d for d, _ in got} - {"UNKNOWN"}  # some polarity is read


def test_enrich_directions_many_equals_jax(readers):
    jr, tr = readers
    images = [_image(n) for n in REAL]
    ref = jdirections.enrich_directions_many(images, [_gt(n, JBox) for n in REAL], jr)
    got = tdirections.enrich_directions_many(images, [_gt(n) for n in REAL], tr)
    def key(boxes):
        return [(b.class_name, b.semantic_direction, b.semantic_reason) for b in boxes]

    assert [key(g) for g in got] == [key(r) for r in ref]
    # one image at a time gives the same as the chunk
    single = [tdirections.enrich_directions(img, _gt(n), tr) for img, n in zip(images, REAL)]
    assert [key(s) for s in single] == [key(g) for g in got]


class _DirectionReads:
    """A client whose batched direction read raises `exc`."""

    def __init__(self, exc):
        self.exc = exc

    def get_directions_batch(self, crops, classes):
        raise self.exc


def test_direction_ladder_unknown_on_data_errors_raises_on_device_faults(caplog):
    image = _image("ac_rc")
    boxes = _gt("ac_rc")
    caplog.set_level(logging.ERROR)
    out = tdirections.enrich_directions(image, boxes, _DirectionReads(ValueError("unreadable")),
                                        EnrichConfig())
    assert {b.semantic_direction for b in out if b.class_name in
            tdirections.taxonomy.DIRECTION_CLASSES} == {"UNKNOWN"}
    assert "unreadable" in caplog.text
    for exc in (KernelError("launch failed"),
                RuntimeError("cuDNN error: CUDNN_STATUS_EXECUTION_FAILED")):
        with pytest.raises(type(exc)):
            tdirections.enrich_directions(image, boxes, _DirectionReads(exc))
        with pytest.raises(type(exc)):
            tdirections.enrich_directions_many([image], [boxes], _DirectionReads(exc))


def test_enrich_directions_refuses_a_client_without_the_batched_read():
    """Kept under its old name: a client without get_directions_batch is
    read a crop at a time, as the JAX package's per-crop dispatch reads
    it, image by image across a chunk."""
    class PerCrop:
        def get_direction(self, crop, cls):
            return "UP", cls.upper()

    image, boxes = _image("ac_rc"), _gt("ac_rc")
    jboxes = _gt("ac_rc", JBox)
    want = jdirections.enrich_directions(image, jboxes, PerCrop())
    for got in (tdirections.enrich_directions(image, boxes, PerCrop()),
                tdirections.enrich_directions_many([image, image], [boxes, boxes],
                                                   PerCrop())[1]):
        assert [(b.semantic_direction, b.semantic_reason) for b in got] == \
            [(b.semantic_direction, b.semantic_reason) for b in want]
    assert any(b.semantic_direction == "UP" for b in want)


@pytest.mark.parametrize("exc,fault", [
    (KernelError("launch failed"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (RuntimeError("cuDNN error: CUDNN_STATUS_EXECUTION_FAILED"), True),
    (RuntimeError("CUDA error: CUBLAS_STATUS_EXECUTION_FAILED when calling `cublasSgemm`"), True),
    (RuntimeError("cuBLAS error: CUBLAS_STATUS_NOT_INITIALIZED"), True),
    (ValueError("unreadable crop"), False),
    (RuntimeError("shape '[2, 3]' is invalid for input of size 5"), False),
])
def test_device_faults_are_told_from_data_errors(exc, fault):
    """What the ladders re-raise: kernel faults, and torch's errors from
    the CUDA runtime, cuDNN and cuBLAS; anything else is the data's."""
    assert is_device_fault(exc) == fault


def test_get_labels_raises_as_jax(readers):
    jr, tr = readers
    for r in (jr, tr):
        with pytest.raises(NotImplementedError, match="get_labels_batch_boxes"):
            r.get_labels(np.zeros((8, 8, 3), np.uint8))


def test_reader_runs_on_the_card_unless_told(readers):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_trained_reader(READER)
    assert readers[1].device.type == "cpu"


def test_default_client(monkeypatch, tmp_path, caplog):
    for k in ("CIRCUITVISION_VLM", "GEMINI_API_KEY", "OPENROUTER_API_KEY"):
        monkeypatch.delenv(k, raising=False)
    assert tclient.default_client(device="cpu") is None
    monkeypatch.setenv("CIRCUITVISION_VLM", f"reader:{READER}")
    assert isinstance(tclient.default_client(device="cpu"), TrainedReaderClient)
    monkeypatch.setenv("CIRCUITVISION_VLM", f"reader:{tmp_path}")  # no checkpoint there
    with pytest.raises(FileNotFoundError):
        tclient.default_client(device="cpu")
    monkeypatch.setenv("CIRCUITVISION_VLM", "paligemma:/x")  # no checkpoint there
    with pytest.raises(FileNotFoundError):
        tclient.default_client(device="cpu")
    monkeypatch.delenv("CIRCUITVISION_VLM")
    monkeypatch.setenv("GEMINI_API_KEY", "k")
    caplog.set_level(logging.WARNING)
    client = tclient.default_client(device="cpu")
    assert isinstance(client, tclient.GeminiVLMClient) and client.api_key == "k"
    assert "not ported" not in caplog.text


# --------------------------------------------------------------- fix_netlist
_LINES = [("V", 1, 0, 1, None, "voltage.dc", "voltage.dc_10_10_40_60"),
          ("R", 1, 1, 2, None, "resistor", "resistor_100_10_160_40"),
          ("R", 2, 2, 0, "4.7k", "resistor", "resistor_200_10_260_40"),
          ("C", 1, 2, 0, None, "capacitor", "capacitor_300_10_330_60"),
          ("I", 1, 0, 2, "2", "current.dc", "current.dc_400_10_440_60"),
          ("", None, 1, 0, None, "", "junction_5_5_9_9")]
#: visual ids by uid; the capacitor has none (missing id)
_IDS = {"voltage.dc_10_10_40_60": 3, "resistor_100_10_160_40": 1,
        "resistor_200_10_260_40": 2, "current.dc_400_10_440_60": 4, "junction_5_5_9_9": 5}
CANNED = {
    "plain": [{"id": "1", "class": "resistor", "value": "10k"},
              {"id": 3, "class": "voltage.dc", "value": "5"},
              {"id": "4", "class": "current.dc", "value": "abc"}],
    "missing_ids": [{"id": "9", "class": "resistor", "value": "1"}],
    "unknown_class": [{"id": "2", "class": "flux.capacitor", "value": "88"},
                      {"id": "5", "class": "gnd", "value": None}],
    "malformed_row": [{"id": "1"}, {"class": "resistor", "value": "1"},
                      {"id": "4", "class": "voltage.dc", "value": None}, {"id": "3", "class": ""}],
}


def _netlist(line_type, box_type):
    lines = [line_type(t, n, a, b, v, class_name=c, persistent_uid=u)
             for t, n, a, b, v, c, u in _LINES]
    boxes = [box_type("x", 1.0, 0, 0, 1, 1, persistent_uid=u, visual_id=i)
             for u, i in _IDS.items()]
    return lines, boxes


@pytest.mark.parametrize("case", sorted(CANNED))
def test_fix_netlist_equals_jax(case):
    rows = CANNED[case]
    t_lines, t_boxes = _netlist(NetlistLine, BBox)
    j_lines, j_boxes = _netlist(JLine, JBox)
    got = [ln.stringify() for ln in fix_netlist(t_lines, rows, t_boxes)]
    ref = [ln.stringify() for ln in jax_fix(j_lines, rows, j_boxes)]
    assert "\n".join(got) == "\n".join(ref)
    assert [(ln.class_name, ln.component_type, ln.visual_id) for ln in t_lines] == \
        [(ln.class_name, ln.component_type, ln.visual_id) for ln in j_lines]


def test_fix_netlist_raises_alike_on_a_row_that_is_not_a_dict():
    t_lines, t_boxes = _netlist(NetlistLine, BBox)
    j_lines, j_boxes = _netlist(JLine, JBox)
    for fn, lines, boxes in ((fix_netlist, t_lines, t_boxes), (jax_fix, j_lines, j_boxes)):
        with pytest.raises(AttributeError):
            fn(lines, ["not a row"], boxes)


def test_client_is_box_driven(readers):
    _jr, tr = readers
    assert isinstance(tr, TrainedReaderClient)
    assert tr.get_labels_batch_boxes([np.zeros((10, 10, 3), np.uint8)], [[]]) == [[]]
