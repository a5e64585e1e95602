"""Synthetic schematic renderer for the eval set and the end-to-end bench:
the JAX package's `eval/synth.py`, byte for byte, writing its PNGs with
`io/image_io.encode_png` instead of PIL.

Renders small circuits as white-background images with black wire strokes
(the classical adaptive-threshold mask recovers the wire raster exactly
like a clean scanned schematic), plus ground-truth detections, the wire
mask, canned stage-2 VLM labels (values), and the pinned final netlist
text each circuit must produce through the classical pipeline with
oracle detections.

The pinned netlists are verified two ways: against the drawn topology
by hand, and byte-for-byte against the REFERENCE implementation's own
host pipeline run on identical (mask, boxes) inputs
(tests/test_reference_diff.py); they are the north-star fidelity target
of BASELINE.md ("netlist text exact-match").

Reference data layout consumed by scripts/eval_pipeline.py:
    images/<name>.png     netlists/<name>.cir
    boxes/<name>.json     masks/<name>.png      labels/<name>.json
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np

from ..core.types import BBox

STROKE = 3  # wire thickness in px at scale 1


@dataclasses.dataclass
class SynthCircuit:
    name: str
    image: np.ndarray          # (H, W, 3) uint8 white bg / black strokes
    boxes: list                # GT detections (full-image coords)
    wire_mask: np.ndarray      # (H, W) uint8 0/255 wires only
    vlm_labels: list           # canned stage-2 VLM output (values)
    directions: dict           # {class: (direction, reason)} stage-1 VLM
    netlist_text: str          # pinned FINAL netlist (values merged)
    valueless_text: str        # pinned valueless netlist
    category: str = "basic"    # eval report bucket
    #: when set, write_eval_set stores the image PRE-rotated with this
    #: EXIF orientation tag — the loader must auto-rotate it upright
    #: (reference process_new_upload, src/analysis_pipeline.py:64-91)
    exif_orientation: int = 0


def _bbox(cls, x0, y0, x1, y1, conf=0.9):
    return BBox(class_name=cls, confidence=conf, xmin=x0, ymin=y0, xmax=x1, ymax=y1)


class _Canvas:
    """Wire strokes are drawn into BOTH the image (black) and the GT mask
    (white); component glyphs go into the image only."""

    def __init__(self, h: int, w: int, t: int = STROKE):
        self.image = np.full((h, w, 3), 255, np.uint8)
        self.mask = np.zeros((h, w), np.uint8)
        self.t = t

    def hwire(self, y, x0, x1):
        self.image[y : y + self.t, x0:x1] = 0
        self.mask[y : y + self.t, x0:x1] = 255

    def vwire(self, x, y0, y1):
        self.image[y0:y1, x : x + self.t] = 0
        self.mask[y0:y1, x : x + self.t] = 255

    def glyph_box(self, x0, y0, x1, y1):
        """Hollow rectangle inside a component bbox (image only — node
        extraction subtracts the bbox, so glyph pixels never reach the
        topology)."""
        self.image[y0:y1, x0 : x0 + 2] = 0
        self.image[y0:y1, x1 - 2 : x1] = 0
        self.image[y0 : y0 + 2, x0:x1] = 0
        self.image[y1 - 2 : y1, x0:x1] = 0


def golden() -> SynthCircuit:
    """The 4-node golden circuit (tests/test_golden_circuit.py layout)."""
    c = _Canvas(400, 500)
    c.hwire(60, 60, 440)
    c.vwire(60, 60, 340)
    c.vwire(250, 60, 340)
    c.vwire(437, 60, 340)
    c.hwire(337, 60, 440)
    c.vwire(60, 337, 380)
    boxes = [
        _bbox("voltage.dc", 45, 150, 78, 250),
        _bbox("resistor", 110, 45, 190, 78),
        _bbox("resistor", 300, 45, 380, 78),
        _bbox("capacitor.unpolarized", 235, 150, 268, 250),
        _bbox("gnd", 45, 355, 78, 385),
        _bbox("junction", 245, 330, 258, 345),
        _bbox("text", 110, 10, 180, 30),
    ]
    for b in boxes:
        if b.class_name not in ("junction", "text"):
            c.glyph_box(b.xmin + 4, b.ymin + 4, b.xmax - 4, b.ymax - 4)
    labels = [
        {"id": "1", "class": "voltage.dc", "value": "10"},
        {"id": "2", "class": "resistor", "value": "1k"},
        {"id": "3", "class": "resistor", "value": "2k"},
        {"id": "4", "class": "capacitor.unpolarized", "value": "1u"},
        {"id": "5", "class": "gnd", "value": None},
    ]
    return SynthCircuit(
        name="golden",
        image=c.image,
        boxes=boxes,
        wire_mask=c.mask,
        vlm_labels=labels,
        directions={"voltage.dc": ("UP", "SIGN")},
        netlist_text="V1 0 2 10\nR1 2 1 1k\nR2 1 0 2k\nC1 1 0 1u",
        valueless_text="V1 0 2 None\nR1 1 0 None\nC1 1 0 None\nR2 2 1 None",
    )


def loop() -> SynthCircuit:
    """Single V–R loop (tests/test_pipeline.py layout)."""
    c = _Canvas(300, 400)
    c.hwire(50, 50, 313)
    c.hwire(250, 50, 313)
    c.vwire(50, 50, 253)
    c.vwire(310, 50, 253)
    boxes = [
        _bbox("voltage.dc", 35, 120, 70, 180),
        _bbox("resistor", 150, 35, 250, 70),
    ]
    for b in boxes:
        c.glyph_box(b.xmin + 4, b.ymin + 4, b.xmax - 4, b.ymax - 4)
    labels = [
        {"id": "1", "class": "voltage.dc", "value": "10"},
        {"id": "2", "class": "resistor", "value": "1k"},
    ]
    return SynthCircuit(
        name="loop",
        image=c.image,
        boxes=boxes,
        wire_mask=c.mask,
        vlm_labels=labels,
        directions={"voltage.dc": ("UP", "SIGN")},
        netlist_text="V1 0 1 10\nR1 1 0 1k",
        valueless_text="V1 0 1 None\nR1 1 0 None",
    )


def parallel_r() -> SynthCircuit:
    """V source feeding two parallel resistors; gnd stub bottom-left."""
    c = _Canvas(350, 450)
    c.hwire(60, 60, 400)
    c.hwire(290, 60, 400)
    c.vwire(60, 60, 293)     # V branch
    c.vwire(220, 60, 293)    # R1 branch
    c.vwire(397, 60, 293)    # R2 branch
    c.vwire(60, 290, 330)    # gnd stub
    boxes = [
        _bbox("voltage.dc", 45, 130, 78, 220),
        _bbox("resistor", 205, 130, 238, 220),
        _bbox("resistor", 382, 130, 415, 220),
        _bbox("gnd", 45, 305, 78, 335),
    ]
    for b in boxes:
        c.glyph_box(b.xmin + 4, b.ymin + 4, b.xmax - 4, b.ymax - 4)
    labels = [
        {"id": "1", "class": "voltage.dc", "value": "5"},
        {"id": "2", "class": "resistor", "value": "100"},
        {"id": "3", "class": "resistor", "value": "200"},
        {"id": "4", "class": "gnd", "value": None},
    ]
    return SynthCircuit(
        name="parallel_r",
        image=c.image,
        boxes=boxes,
        wire_mask=c.mask,
        vlm_labels=labels,
        directions={"voltage.dc": ("UP", "SIGN")},
        netlist_text="V1 0 1 5\nR1 1 0 100\nR2 1 0 200",
        valueless_text="V1 0 1 None\nR1 1 0 None\nR2 1 0 None",
    )


def series_rl() -> SynthCircuit:
    """Series V–R–L loop: R on the top rail, L on the right vertical."""
    c = _Canvas(300, 450)
    c.hwire(50, 50, 348)
    c.hwire(250, 50, 348)
    c.vwire(50, 50, 253)
    c.vwire(345, 50, 253)
    c.vwire(50, 250, 285)    # gnd stub
    boxes = [
        _bbox("voltage.dc", 35, 110, 68, 190),
        _bbox("resistor", 150, 35, 230, 68),
        _bbox("inductor", 330, 110, 363, 190),
        _bbox("gnd", 35, 260, 68, 290),
    ]
    for b in boxes:
        c.glyph_box(b.xmin + 4, b.ymin + 4, b.xmax - 4, b.ymax - 4)
    labels = [
        {"id": "1", "class": "voltage.dc", "value": "12"},
        {"id": "2", "class": "resistor", "value": "1k"},
        {"id": "3", "class": "inductor", "value": "10m"},
        {"id": "4", "class": "gnd", "value": None},
    ]
    return SynthCircuit(
        name="series_rl",
        image=c.image,
        boxes=boxes,
        wire_mask=c.mask,
        vlm_labels=labels,
        directions={"voltage.dc": ("UP", "SIGN")},
        netlist_text="V1 0 2 12\nR1 2 1 1k\nL1 1 0 10m",
        valueless_text="V1 0 2 None\nL1 1 0 None\nR1 2 1 None",
    )


def ac_rc() -> SynthCircuit:
    """AC source with series R (top) and C (right vertical)."""
    c = _Canvas(320, 420)
    c.hwire(55, 55, 373)
    c.hwire(265, 55, 373)
    c.vwire(55, 55, 268)
    c.vwire(370, 55, 268)
    c.vwire(55, 265, 300)    # gnd stub
    boxes = [
        _bbox("voltage.ac", 40, 120, 73, 200),
        _bbox("resistor", 150, 40, 230, 73),
        _bbox("capacitor.unpolarized", 355, 120, 388, 200),
        _bbox("gnd", 40, 275, 73, 305),
    ]
    for b in boxes:
        c.glyph_box(b.xmin + 4, b.ymin + 4, b.xmax - 4, b.ymax - 4)
    labels = [
        {"id": "1", "class": "voltage.ac", "value": "4:-45"},
        {"id": "2", "class": "resistor", "value": "100"},
        {"id": "3", "class": "capacitor.unpolarized", "value": "1u"},
        {"id": "4", "class": "gnd", "value": None},
    ]
    return SynthCircuit(
        name="ac_rc",
        image=c.image,
        boxes=boxes,
        wire_mask=c.mask,
        vlm_labels=labels,
        directions={"voltage.ac": ("UP", "SIGN")},
        netlist_text="V1 0 2 4:-45\nR1 2 1 100\nC1 1 0 1u",
        valueless_text="V1 0 2 None\nC1 1 0 None\nR1 2 1 None",
    )


def _glyphify(c: SynthCircuit, seed: int) -> SynthCircuit:
    """Re-render a hand-built circuit with class-distinct glyphs and
    printed values pinned to its canned stage-2 labels (topology pins
    unchanged: all new ink lands inside GT boxes, and printed values
    equal the canned rows byte-for-byte)."""
    from .glyphs import render_schematic

    rng = np.random.default_rng(seed)
    img, _vals, _dirs, text_boxes = render_schematic(
        c.wire_mask, c.boxes, rng,
        value_overrides=_value_overrides_from_labels(c.boxes, c.vlm_labels),
        direction_overrides=_direction_overrides(c.boxes, c.directions),
    )
    return dataclasses.replace(
        c, image=img, boxes=list(c.boxes) + list(text_boxes)
    )


def make_circuits() -> list[SynthCircuit]:
    return [
        _glyphify(c, seed=11 + i)
        for i, c in enumerate(
            [golden(), loop(), parallel_r(), series_rl(), ac_rc()]
        )
    ]


# ---------------------------------------------------------------------------
# Hostile eval categories. Pinned netlists for these live in
# pinned_netlists.json, generated by scripts/pin_eval_netlists.py, which runs
# the full pipeline AND cross-checks the valueless netlist byte-for-byte
# against the reference implementation's own topology chain before pinning.

_CLASS_VALUES = {
    "resistor": "1k", "capacitor": "1u", "capacitor.unpolarized": "1u",
    "inductor": "10m", "voltage.dc": "5", "voltage.ac": "4:-45",
    "current.dc": "2m", "diode": None, "diode.zener": None,
    "diode.light_emitting": None, "transistor.bjt": None, "unknown": None,
    "gnd": None, "terminal": None,
}

#: class-level stage-1 directions for the hostile sets (FakeVLMClient keys)
_HOSTILE_DIRECTIONS = {
    "voltage.dc": ("UP", "SIGN"),
    "voltage.ac": ("UP", "SIGN"),
    "voltage.battery": ("UP", "SIGN"),
    "diode": ("LEFT", "ARROW"),
    "diode.zener": ("RIGHT", "ARROW"),
    "diode.light_emitting": ("DOWN", "ARROW"),
    "transistor.bjt": ("UP", "SIGN"),
    "current.dc": ("DOWN", "ARROW"),
    "unknown": ("UNKNOWN", "UNKNOWN"),
}

_NON_ENUM = {"text", "junction", "crossover", "explanatory", "circuit", "vss"}


def _labels_for(boxes) -> list:
    out = []
    vid = 1
    for b in boxes:
        if b.class_name in _NON_ENUM:
            continue
        out.append(
            {"id": str(vid), "class": b.class_name,
             "value": _CLASS_VALUES.get(b.class_name)}
        )
        vid += 1
    return out


def _render_image(mask: np.ndarray, boxes) -> np.ndarray:
    """White-background render: wires black, component glyphs as box
    outlines (inside the detection box, so subtraction removes them —
    the classical mask then recovers wires + in-box glyphs like a clean
    scan)."""
    img = np.full((mask.shape[0], mask.shape[1], 3), 255, np.uint8)
    img[mask > 0] = 0
    for b in boxes:
        if b.class_name in _NON_ENUM:
            continue
        x0, y0 = b.xmin + 4, b.ymin + 4
        x1, y1 = b.xmax - 4, b.ymax - 4
        if x1 - x0 > 4 and y1 - y0 > 4:
            img[y0:y1, x0 : x0 + 2] = 0
            img[y0:y1, x1 - 2 : x1] = 0
            img[y0 : y0 + 2, x0:x1] = 0
            img[y1 - 2 : y1, x0:x1] = 0
    return img


def _pinned() -> dict:
    import json as _json

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "pinned_netlists.json")
    if os.path.exists(path):
        with open(path) as f:
            return _json.load(f)
    return {}


_VALID_DIRS = {"UP", "DOWN", "LEFT", "RIGHT"}


def _direction_overrides(boxes, directions: dict) -> dict:
    """{uid: direction} for glyph rendering from a class-level canned
    direction map — the drawn polarity marks then agree with what the
    frozen VLM will assert, so pixels-only readers reproduce the pins."""
    out = {}
    for b in boxes:
        d = directions.get(b.class_name)
        if d and d[0] in _VALID_DIRS:
            out[b.persistent_uid] = d[0]
    return out


def _value_overrides_from_labels(boxes, labels) -> dict:
    """{uid: value-or-None} pinning printed values to the canned stage-2
    rows (None suppresses printing so pixels carry exactly the canned
    values, no more)."""
    out = {}
    rows = iter(labels)
    for b in boxes:
        if b.class_name in _NON_ENUM:
            continue
        row = next(rows, None)
        if row is None:
            break
        out[b.persistent_uid] = row.get("value")
    return out


def _labels_from_values(boxes, values: dict) -> list:
    """Canned stage-2 rows whose values are exactly what the render
    printed (sampled values become the frozen-VLM ground truth)."""
    out, vid = [], 1
    for b in boxes:
        if b.class_name in _NON_ENUM:
            continue
        out.append({"id": str(vid), "class": b.class_name,
                    "value": values.get(b.persistent_uid)})
        vid += 1
    return out


def _from_mask(name, category, mask, boxes, pins, directions=None,
               exif_orientation=0) -> SynthCircuit:
    """Glyph-rendered circuit: class-distinct symbols + printed values
    (sampled, then canned as the frozen-VLM rows) + annotation ink in
    `text` boxes. Value-text boxes join the GT detections, so the
    full-model eval scores text detection too."""
    from .glyphs import render_schematic

    import zlib

    dirs = dict(directions if directions is not None else _HOSTILE_DIRECTIONS)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    img, values, _dirs, text_boxes = render_schematic(
        mask, boxes, rng,
        direction_overrides=_direction_overrides(boxes, dirs),
    )
    pin = pins.get(name, {})
    return SynthCircuit(
        name=name,
        image=img,
        boxes=list(boxes) + list(text_boxes),
        wire_mask=mask,
        vlm_labels=_labels_from_values(boxes, values),
        directions=dirs,
        netlist_text=pin.get("final", ""),
        valueless_text=pin.get("valueless", ""),
        category=category,
        exif_orientation=exif_orientation,
    )


def semiconductor_circuits(pins) -> list[SynthCircuit]:
    """Randomized ladders with diode/transistor/source classes — pixel
    thresholds 8/20 and ARROW/SIGN prefix overrides exercised end to end
    from images."""
    from .randomized import random_circuit

    out = []
    for i, seed in enumerate((2001, 2002, 2003, 2004, 2005, 2006)):
        mask, boxes = random_circuit(seed)
        for b in boxes:  # class-level directions come from the VLM stage
            b.semantic_direction = None
            b.semantic_reason = None
        out.append(_from_mask(f"semi_{i}", "semiconductors", mask, boxes, pins))
    return out


def threshold_edge_circuits(pins) -> list[SynthCircuit]:
    """V+R loop plus isolated specks with contour areas straddling the
    4e-4 relative keep threshold (reference :410) — exercises the
    keep/drop boundary and the id shifts it causes."""
    out = []
    for i, sides in enumerate(((4, 7), (9, 12), (15, 22))):
        c = _Canvas(300, 400)
        c.hwire(50, 50, 313)
        c.hwire(250, 50, 313)
        c.vwire(50, 50, 253)
        c.vwire(310, 50, 253)
        boxes = [
            _bbox("voltage.dc", 35, 120, 70, 180),
            _bbox("resistor", 150, 35, 250, 70),
        ]
        for b in boxes:
            c.glyph_box(b.xmin + 4, b.ymin + 4, b.xmax - 4, b.ymax - 4)
        # specks: at H=600 analysis space the areas scale by (600/300)² —
        # these sides straddle 4e-4 · 600 · 800 ≈ 192 px² post-resize.
        for j, s in enumerate(sides):
            x = 120 + 90 * j
            c.mask[285 : 285 + s, x : x + s] = 255
            c.image[285 : 285 + s, x : x + s] = 0
        out.append(
            _from_mask(f"edge_{i}", "threshold-edge", c.mask, boxes, pins,
                       directions={"voltage.dc": ("UP", "SIGN")})
        )
    # edge_3: wires running along / touching the raster border — contour
    # extraction must keep border-touching external contours identical to
    # cv2's RETR_EXTERNAL semantics (SURVEY §7 hard part #2). Components
    # spread so the padded crop window exceeds 90% of the image and the
    # crop is SKIPPED (reference :1171-1181) — the border wires must
    # reach the topology stage intact.
    c = _Canvas(300, 400)
    c.hwire(0, 0, 400)
    c.hwire(297, 0, 400)
    c.vwire(0, 0, 300)
    c.vwire(396, 0, 300)
    c.vwire(200, 0, 300)
    boxes = [
        _bbox("voltage.dc", 0, 100, 30, 170),
        _bbox("resistor", 80, 0, 160, 30),
        _bbox("resistor", 185, 120, 215, 200),
        _bbox("capacitor", 250, 240, 320, 300),
    ]
    for b in boxes:
        c.glyph_box(b.xmin + 4, b.ymin + 4, b.xmax - 4, b.ymax - 4)
    out.append(
        _from_mask("edge_3", "threshold-edge", c.mask, boxes, pins,
                   directions={"voltage.dc": ("UP", "SIGN")})
    )
    return out


def multi_cluster_circuits(pins) -> list[SynthCircuit]:
    """Two separated circuit clusters + text near the main one — the crop
    stage must pick the text-associated cluster (reference cluster
    scoring, src/circuit_analyzer.py:1071-1136)."""
    out = []
    for i, (main_x, sec_x) in enumerate(((40, 520), (260, 40), (40, 470))):
        c = _Canvas(360, 700)
        # main cluster: V + 2R ladder
        mx = main_x
        c.hwire(60, mx, mx + 200)
        c.hwire(280, mx, mx + 200)
        c.vwire(mx, 60, 283)
        c.vwire(mx + 100, 60, 283)
        c.vwire(mx + 197, 60, 283)
        boxes = [
            _bbox("voltage.dc", mx - 15, 140, mx + 18, 210),
            _bbox("resistor", mx + 85, 140, mx + 118, 210),
            _bbox("resistor", mx + 182, 140, mx + 215, 210),
            _bbox("text", mx + 40, 20, mx + 120, 38),
        ]
        # secondary cluster: small floating loop (no text)
        sx = sec_x
        c.hwire(120, sx, sx + 90)
        c.hwire(200, sx, sx + 90)
        c.vwire(sx, 120, 203)
        c.vwire(sx + 87, 120, 203)
        boxes.append(_bbox("resistor", sx + 30, 105, sx + 60, 135))
        for b in boxes:
            if b.class_name != "text":
                c.glyph_box(b.xmin + 4, b.ymin + 4, b.xmax - 4, b.ymax - 4)
        out.append(
            _from_mask(f"cluster_{i}", "multi-cluster", c.mask, boxes, pins,
                       directions={"voltage.dc": ("UP", "SIGN")})
        )
    return out


def exif_circuits(pins) -> list[SynthCircuit]:
    """Upright circuits stored PRE-rotated with EXIF orientation tags —
    the ingest path must auto-rotate (reference EXIF transpose,
    src/analysis_pipeline.py:67-77)."""
    base = make_circuits()[:3]  # glyphified golden / loop / parallel_r
    out = []
    for i, (c, orient) in enumerate(zip(base, (6, 8, 3))):
        pin = pins.get(f"exif_{i}", {})
        out.append(
            dataclasses.replace(
                c,
                name=f"exif_{i}",
                category="exif-rotated",
                exif_orientation=orient,
                netlist_text=pin.get("final", c.netlist_text),
                valueless_text=pin.get("valueless", c.valueless_text),
            )
        )
    return out


def degenerate_circuits(pins) -> list[SynthCircuit]:
    """Degradation-ladder cases run end-to-end from images (SURVEY §5):
    every one must produce a DETERMINISTIC netlist, not an exception.

    degen_0 — components but NO wires: node analysis finds nothing and
    the pipeline emits the components-only fallback netlist
    (src/analysis_pipeline.py:310-323; the reference's own fallback call
    is a TypeError — documented deviation, PARITY.md).
    degen_1 — closed R/C loop with NO source: ground selection cannot use
    a source-connected node and falls through the max-connection /
    lowest-node ladder (src/circuit_analyzer.py:1499-1545).
    degen_2 — one single-net resistor (skipped by the two-node guard,
    :1680-1684) plus a dangling terminal (type-N line, node_2=0).
    """
    out = []

    # degen_0: detections, empty wire raster.
    c = _Canvas(300, 400)
    boxes = [
        _bbox("voltage.dc", 35, 120, 70, 180),
        _bbox("resistor", 150, 35, 250, 70),
        _bbox("gnd", 35, 260, 68, 290),
    ]
    for b in boxes:
        c.glyph_box(b.xmin + 4, b.ymin + 4, b.xmax - 4, b.ymax - 4)
    out.append(
        _from_mask("degen_0", "degenerate", c.mask, boxes, pins,
                   directions={"voltage.dc": ("UP", "SIGN")})
    )

    # degen_1: R-C loop, no source anywhere.
    c = _Canvas(300, 400)
    c.hwire(50, 50, 313)
    c.hwire(250, 50, 313)
    c.vwire(50, 50, 253)
    c.vwire(310, 50, 253)
    boxes = [
        _bbox("capacitor", 35, 120, 70, 180),
        _bbox("resistor", 150, 35, 250, 70),
    ]
    for b in boxes:
        c.glyph_box(b.xmin + 4, b.ymin + 4, b.xmax - 4, b.ymax - 4)
    out.append(
        _from_mask("degen_1", "degenerate", c.mask, boxes, pins,
                   directions={}))

    # degen_2: single-net resistor on a stub + dangling terminal.
    c = _Canvas(300, 400)
    c.hwire(150, 60, 220)          # stub wire: one net
    c.hwire(150, 260, 340)         # separate terminal wire
    boxes = [
        _bbox("resistor", 100, 135, 160, 168),   # sits ON the single net
        _bbox("terminal", 330, 135, 360, 168),   # dangling → type N
    ]
    for b in boxes:
        c.glyph_box(b.xmin + 4, b.ymin + 4, b.xmax - 4, b.ymax - 4)
    out.append(
        _from_mask("degen_2", "degenerate", c.mask, boxes, pins,
                   directions={}))
    return out


def randomized_glyph_circuits(pins) -> list[SynthCircuit]:
    """Randomized glyph-rendered ladders (seeds disjoint from every
    training pool) — the bulk of the full-model eval corpus."""
    from .randomized import random_circuit

    out = []
    for i in range(16):
        mask, boxes = random_circuit(7100 + i)
        for b in boxes:  # class-level directions come from the VLM stage
            b.semantic_direction = None
            b.semantic_reason = None
        out.append(_from_mask(f"fm_{i}", "randomized-glyph", mask, boxes, pins))
    return out


def nested_loop_circuits(pins) -> list[SynthCircuit]:
    """Wire loops inside wire loops (SURVEY §7 hard part #2): contour
    extraction must keep RETR_EXTERNAL semantics for enclosed rings."""
    out = []

    # nested_0: outer V+R loop; UNCONNECTED inner loop with R+C (its own
    # two nets — a floating subcircuit fully inside the outer ring).
    # Components sit on every outer side so the box-driven crop window
    # (pad 80, src/circuit_analyzer.py:1183-1232) keeps the whole ring.
    c = _Canvas(420, 560)
    c.hwire(50, 50, 473)
    c.hwire(370, 50, 473)
    c.vwire(50, 50, 373)
    c.vwire(470, 50, 373)
    c.hwire(150, 150, 373)
    c.hwire(270, 150, 373)
    c.vwire(150, 150, 273)
    c.vwire(370, 150, 273)
    boxes = [
        _bbox("voltage.dc", 35, 170, 68, 250),
        _bbox("resistor", 200, 35, 300, 68),
        _bbox("resistor", 135, 180, 168, 240),
        _bbox("capacitor", 355, 180, 388, 240),
        _bbox("resistor", 453, 170, 486, 250),   # outer right column
        _bbox("resistor", 200, 353, 280, 386),   # outer bottom rail
    ]
    out.append(_from_mask("nested_0", "nested-loop", c.mask, boxes, pins))

    # nested_1: inner loop CONNECTED to the outer by a rung — one merged
    # contour ring system.
    c = _Canvas(420, 560)
    c.hwire(50, 50, 473)
    c.hwire(370, 50, 473)
    c.vwire(50, 50, 373)
    c.vwire(470, 50, 373)
    c.hwire(150, 150, 373)
    c.hwire(270, 150, 373)
    c.vwire(150, 150, 273)
    c.vwire(370, 150, 273)
    c.vwire(260, 50, 153)  # connecting rung outer-top → inner-top
    boxes = [
        _bbox("voltage.dc", 35, 170, 68, 250),
        _bbox("resistor", 245, 85, 278, 130),   # on the connecting rung
        _bbox("resistor", 135, 180, 168, 240),
        _bbox("capacitor", 355, 180, 388, 240),
    ]
    out.append(_from_mask("nested_1", "nested-loop", c.mask, boxes, pins))

    # nested_2: three concentric rings, middle one bridged to both.
    c = _Canvas(520, 620)
    for inset, y0, y1 in ((50, 50, 460), (140, 140, 370), (230, 230, 280)):
        c.hwire(y0, inset, 620 - inset + 3)
        c.hwire(y1, inset, 620 - inset + 3)
        c.vwire(inset, y0, y1 + 3)
        c.vwire(620 - inset, y0, y1 + 3)
    c.vwire(300, 50, 143)    # outer→middle bridge
    c.vwire(380, 370, 463)   # middle→outer bottom bridge
    c.vwire(450, 140, 233)   # middle→inner bridge
    boxes = [
        _bbox("voltage.dc", 35, 200, 68, 300),
        _bbox("resistor", 285, 85, 318, 128),
        _bbox("resistor", 365, 395, 398, 445),
        _bbox("capacitor", 125, 220, 158, 290),
        _bbox("inductor", 250, 215, 300, 248),   # on the innermost ring
        _bbox("capacitor", 300, 265, 370, 298),  # inner bottom rail
        _bbox("resistor", 553, 220, 586, 290),   # outer right column
    ]
    out.append(_from_mask("nested_2", "nested-loop", c.mask, boxes, pins))

    # nested_3: inner loop sharing a rail segment with the outer loop.
    c = _Canvas(400, 520)
    c.hwire(60, 60, 433)
    c.hwire(330, 60, 433)
    c.vwire(60, 60, 333)
    c.vwire(430, 60, 333)
    c.hwire(190, 160, 343)   # inner loop top
    c.vwire(160, 190, 333)   # inner left drops to the SHARED bottom rail
    c.vwire(340, 190, 333)   # inner right drops to the shared rail
    boxes = [
        _bbox("voltage.dc", 45, 150, 78, 240),
        _bbox("resistor", 200, 45, 300, 78),
        _bbox("resistor", 145, 230, 178, 290),
        _bbox("capacitor", 325, 230, 358, 290),
    ]
    out.append(_from_mask("nested_3", "nested-loop", c.mask, boxes, pins))
    return out


def border_wire_circuits(pins) -> list[SynthCircuit]:
    """Wires running ON the raster border and boxes clipped at 0 — the
    border-touching external-contour semantics beyond edge_3."""
    out = []

    # border_0: full border ring as the circuit loop, component boxes
    # clipped at the image edges (one on each border so the box-driven
    # crop window reaches all four).
    c = _Canvas(300, 420)
    c.hwire(0, 0, 420)
    c.hwire(297, 0, 420)
    c.vwire(0, 0, 300)
    c.vwire(417, 0, 300)
    boxes = [
        _bbox("voltage.dc", 0, 100, 28, 180),     # clipped at xmin=0
        _bbox("resistor", 150, 0, 250, 28),       # clipped at ymin=0
        _bbox("resistor", 392, 100, 420, 180),    # clipped at xmax=W
        _bbox("capacitor", 150, 272, 250, 300),   # clipped at ymax=H
    ]
    out.append(_from_mask("border_0", "border-wire", c.mask, boxes, pins))

    # border_1: comb of wires entering from the top border, tied by one
    # bottom rail (components low enough that the 80 px crop padding
    # keeps the rail — reference crops are box-driven,
    # src/circuit_analyzer.py:1183-1232).
    c = _Canvas(340, 480)
    c.hwire(0, 60, 343)      # tying rail ON the top border
    for x in (60, 200, 340):
        c.vwire(x, 0, 218)
    c.hwire(215, 60, 343)
    boxes = [
        _bbox("voltage.dc", 45, 60, 78, 140),
        _bbox("resistor", 185, 60, 218, 140),
        _bbox("resistor", 325, 60, 358, 140),
    ]
    out.append(_from_mask("border_1", "border-wire", c.mask, boxes, pins))

    # border_2: L-shaped run hugging two borders with a gnd stub.
    c = _Canvas(320, 440)
    c.hwire(0, 0, 440)
    c.vwire(0, 0, 320)
    c.hwire(150, 0, 240)
    c.vwire(237, 0, 153)
    boxes = [
        _bbox("voltage.dc", 0, 40, 30, 110),
        _bbox("resistor", 100, 135, 180, 168),
        _bbox("resistor", 222, 40, 255, 110),
        _bbox("gnd", 90, 0, 130, 26),
    ]
    out.append(_from_mask("border_2", "border-wire", c.mask, boxes, pins))
    return out


def aspect_circuits(pins) -> list[SynthCircuit]:
    """Extreme aspect ratios: the resize-to-H600 analysis space blows
    wide rasters up ~3x in width and squeezes tall ones."""
    out = []

    # aspect_0/1: very wide chains (1400x240, 1200x200). Rung spacing
    # stays under the cluster proximity threshold (~2x the 68 px
    # component diagonal, src/circuit_analyzer.py:1003-1023) so the
    # whole chain is ONE cluster and the crop keeps it all.
    for i, w in enumerate((1400, 1200)):
        c = _Canvas(240, w)
        c.hwire(40, 40, w - 40)
        c.hwire(190, 40, w - 40)
        xs = np.arange(70, w - 60, 110)
        boxes = []
        for j, x in enumerate(xs):
            c.vwire(int(x), 40, 193)
            cls = "voltage.dc" if j == 0 else ("capacitor" if j % 3 == 2
                                               else "resistor")
            boxes.append(_bbox(cls, int(x) - 17, 85, int(x) + 16, 145))
        out.append(_from_mask(f"aspect_{i}", "extreme-aspect", c.mask,
                              boxes, pins))

    # aspect_2/3: very tall ladders (1100x260, 900x220).
    for i, h in enumerate((1100, 900)):
        c = _Canvas(h, 260)
        c.vwire(40, 40, h - 40)
        c.vwire(210, 40, h - 40)
        ys = np.arange(70, h - 60, 110)
        boxes = []
        for j, y in enumerate(ys):
            c.hwire(int(y), 40, 213)
            cls = "voltage.dc" if j == 0 else ("inductor" if j % 3 == 2
                                               else "resistor")
            boxes.append(_bbox(cls, 95, int(y) - 17, 155, int(y) + 16))
        out.append(_from_mask(f"aspect_{i + 2}", "extreme-aspect", c.mask,
                              boxes, pins))
    return out


def multiterminal_circuits(pins) -> list[SynthCircuit]:
    """Components touching THREE distinct nets (transistors, op-amp
    style) — the netlist stage must pick its two nodes deterministically
    (reference: first other node containing the same uid,
    src/circuit_analyzer.py:1660-1665)."""
    out = []
    for i, seed in enumerate((41, 42, 43, 44)):
        rng = np.random.default_rng(seed)
        c = _Canvas(400, 560)
        c.hwire(100, 60, 503)          # top rail (within crop padding)
        c.hwire(300, 60, 503)          # bottom rail
        # source rung
        c.vwire(100, 100, 303)
        # transistor rung: vertical wire through the bjt box...
        tx = 260 + int(rng.integers(-30, 30))
        c.vwire(tx, 100, 303)
        # ...plus a base tap entering from a third net
        by = 195 + int(rng.integers(-10, 10))
        c.hwire(by, tx - 110, tx)
        c.vwire(tx - 110, by, 303)     # base branch ties to bottom rail
        boxes = [
            _bbox("voltage.dc", 85, 150, 118, 240),
            _bbox("transistor.bjt", tx - 26, by - 35, tx + 28, by + 35),
            _bbox("resistor", tx - 125, 235, tx - 92, 295),
        ]
        # an extra load on the right
        c.vwire(430, 100, 303)
        boxes.append(_bbox("resistor", 415, 150, 448, 240))
        out.append(_from_mask(f"multiterm_{i}", "multi-terminal", c.mask,
                              boxes, pins))
    return out


def handdrawn_circuits(pins) -> list[SynthCircuit]:
    """Hand-drawn-style renders (eval/handdrawn.py): wobbly pen strokes
    with curvature and width variation — the reference's real-photo
    domain proxy (README.md:119, 267 hand-drawn fine-tune images)."""
    from .handdrawn import handdrawn_circuit

    out = []
    for i in range(8):
        img, mask, boxes, values, _dirs, text_boxes = handdrawn_circuit(
            8200 + i, direction_overrides_classes=_HOSTILE_DIRECTIONS
        )
        pin = pins.get(f"hand_{i}", {})
        out.append(
            SynthCircuit(
                name=f"hand_{i}",
                image=img,
                boxes=list(boxes) + list(text_boxes),
                wire_mask=mask,
                vlm_labels=_labels_from_values(boxes, values),
                directions=dict(_HOSTILE_DIRECTIONS),
                netlist_text=pin.get("final", ""),
                valueless_text=pin.get("valueless", ""),
                category="hand-drawn",
            )
        )
    return out


def make_hostile_circuits() -> list[SynthCircuit]:
    pins = _pinned()
    return (
        semiconductor_circuits(pins)
        + threshold_edge_circuits(pins)
        + multi_cluster_circuits(pins)
        + exif_circuits(pins)
        + degenerate_circuits(pins)
        + randomized_glyph_circuits(pins)
        + nested_loop_circuits(pins)
        + border_wire_circuits(pins)
        + aspect_circuits(pins)
        + multiterminal_circuits(pins)
        + handdrawn_circuits(pins)
    )


def make_all_circuits() -> list[SynthCircuit]:
    """5 basic + 58 hostile circuits (the full eval set)."""
    return make_circuits() + make_hostile_circuits()


def write_eval_set(root: str, circuits: Optional[Sequence[SynthCircuit]] = None):
    """Write circuits in the eval-set layout scripts/eval_pipeline.py reads."""
    from ..io.image_io import encode_png

    # Inverse of PIL ImageOps.exif_transpose's per-tag transform: the
    # stored image such that the loader's transpose recovers the upright
    # render (PIL's ROTATE_180, ROTATE_90 and ROTATE_270, counterclockwise).
    inverse_transpose = {
        3: lambda a: np.rot90(a, 2),
        6: lambda a: np.rot90(a, 1),
        8: lambda a: np.rot90(a, 3),
    }

    def write_png(path, arr, orientation=None):
        with open(path, "wb") as f:
            f.write(encode_png(arr, exif_orientation=orientation))

    circuits = circuits if circuits is not None else make_all_circuits()
    for sub in ("images", "boxes", "masks", "netlists", "labels"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    categories = {}
    for c in circuits:
        categories[c.name] = c.category
        path = os.path.join(root, "images", f"{c.name}.png")
        if c.exif_orientation in inverse_transpose:
            write_png(path, inverse_transpose[c.exif_orientation](c.image), c.exif_orientation)
        else:
            write_png(path, c.image)
        write_png(os.path.join(root, "masks", f"{c.name}.png"), c.wire_mask)
        with open(os.path.join(root, "boxes", f"{c.name}.json"), "w") as f:
            json.dump(
                [
                    {
                        "class": b.class_name,
                        "confidence": b.confidence,
                        "xmin": b.xmin,
                        "ymin": b.ymin,
                        "xmax": b.xmax,
                        "ymax": b.ymax,
                    }
                    for b in c.boxes
                ],
                f,
                indent=1,
            )
        with open(os.path.join(root, "netlists", f"{c.name}.cir"), "w") as f:
            f.write(c.netlist_text)
        with open(os.path.join(root, "labels", f"{c.name}.json"), "w") as f:
            json.dump(
                {"labels": c.vlm_labels, "directions": c.directions}, f, indent=1
            )
    with open(os.path.join(root, "categories.json"), "w") as f:
        json.dump(categories, f, indent=1)
