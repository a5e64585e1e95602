"""Randomized synthetic circuit topologies for differential testing.

Generates (wire_mask, detections) input pairs for the topology→netlist
chain — the shared input surface of the reference's
`get_node_connections`/`generate_netlist_from_nodes`
(src/circuit_analyzer.py:1286-1770) and this repo's
`topology.nodes.extract_nodes`/`netlist.generate` — with hostile
variation the 5 hand-built eval circuits lack:

  * ladder topologies with 2-4 rails and 2-6 component rungs;
  * diode/transistor/source classes (pixel thresholds 8/20, not just 6);
  * gnd stubs, dangling terminal stubs (type-N lines), unknown classes;
  * random semantic directions/reasons on eligible classes (node-order
    swaps, ARROW/SIGN prefix overrides);
  * noise specks with areas straddling the 4e-4 contour threshold;
  * random raster sizes and stroke widths.

These are INPUTS only — no pinned outputs. The differential harness
(tests/test_reference_diff.py) runs both implementations and requires
byte-identical netlist text.
"""
from __future__ import annotations

import numpy as np

from ..core.types import BBox

COMPONENT_CLASSES = [
    "resistor", "capacitor", "inductor",
    "diode", "diode.zener", "diode.light_emitting",
    "voltage.dc", "voltage.ac", "current.dc",
    "transistor.bjt", "unknown",
]

_DIRECTIONS = ["UP", "DOWN", "LEFT", "RIGHT", "UNKNOWN"]
_REASONS = ["SIGN", "ARROW", "UNKNOWN"]
_DIRECTION_ELIGIBLE = {
    "voltage.dc", "voltage.ac", "diode", "diode.light_emitting",
    "diode.zener", "transistor.bjt", "unknown",
}


def random_circuit(seed: int) -> tuple[np.ndarray, list[BBox]]:
    """One random ladder circuit. Returns (mask, boxes): a 0/255 uint8
    wire raster and oracle detections in the same coordinate space."""
    rng = np.random.default_rng(seed)
    # Raster sizes come from a small bucket set: the per-shape jit
    # programs (stage-A raster prep) compile once per shape, and on the
    # 1-core CI host unbounded shape variety would dominate test time.
    # The interesting variation (classes, thresholds, areas, directions)
    # lives in the mask content, not the canvas size.
    h = int(rng.choice([400, 520, 640]))
    w = int(rng.choice([560, 720, 840]))
    t = int(rng.integers(2, 5))
    mask = np.zeros((h, w), np.uint8)
    boxes: list[BBox] = []

    def hwire(y, x0, x1):
        mask[y : y + t, min(x0, x1) : max(x0, x1)] = 255

    def vwire(x, y0, y1):
        mask[min(y0, y1) : max(y0, y1), x : x + t] = 255

    # Rails 95-150 px apart: far enough for rung components, close enough
    # that the crop stage's proximity clustering (threshold ≈ 2·avg
    # component diagonal, src/circuit_analyzer.py:1003-1023) keeps the
    # whole ladder in ONE cluster.
    n_rails = int(rng.integers(2, 5))
    margin_y = 70
    rail_ys = [int(rng.integers(margin_y, margin_y + 30))]
    for _ in range(n_rails - 1):
        nxt = rail_ys[-1] + int(rng.integers(95, 150))
        if nxt > h - margin_y:
            break
        rail_ys.append(nxt)
    n_rails = len(rail_ys)
    if n_rails < 2:
        rail_ys = [margin_y, min(h - margin_y, margin_y + 150)]
        n_rails = 2

    x_left = int(rng.integers(30, 70))
    x_right = int(w - rng.integers(30, 70))
    for y in rail_ys:
        hwire(y, x_left, x_right)
    # NO bare side wires: rails connect ONLY through component rungs, so
    # every rung component bridges two distinct nets (a closed bare loop
    # would leave most components single-noded → skipped by the
    # reference's :1680-1684 guard → trivially thin netlists).

    def place_component(cls: str, cx: int, cy: int):
        # Sizeable boxes: the crop clustering threshold scales with the
        # average component diagonal, so realistic component sizes keep
        # the ladder a single cluster.
        bw = int(rng.integers(36, 64))
        bh = int(rng.integers(40, 72))
        x0, y0 = cx - bw // 2, cy - bh // 2
        b = BBox(
            class_name=cls,
            confidence=round(float(rng.uniform(0.5, 0.99)), 2),
            xmin=int(x0), ymin=int(y0), xmax=int(x0 + bw), ymax=int(y0 + bh),
        )
        if cls in _DIRECTION_ELIGIBLE and rng.random() < 0.8:
            b.semantic_direction = str(rng.choice(_DIRECTIONS))
            b.semantic_reason = str(rng.choice(_REASONS))
        boxes.append(b)
        return b

    # component rungs between adjacent rails: every adjacent rail pair
    # gets >= 2 rungs (a source + loads) so every net couples to others
    n_rungs = max(int(rng.integers(2 * (n_rails - 1), 7)), 2 * (n_rails - 1))
    # consecutive rungs 70-110 px apart (bounded gaps keep one cluster)
    rung_xs = [x_left + 60 + int(rng.integers(0, 30))]
    while len(rung_xs) < n_rungs and rung_xs[-1] + 110 < x_right - 60:
        rung_xs.append(rung_xs[-1] + int(rng.integers(70, 110)))
    rung_xs = np.asarray(rung_xs)
    pair_assignment = [i % (n_rails - 1) for i in range(len(rung_xs))]
    rng.shuffle(pair_assignment)
    placed_source = False
    for rx, lo in zip(rung_xs, pair_assignment):
        y0, y1 = rail_ys[lo], rail_ys[lo + 1]
        vwire(int(rx), y0, y1 + t)
        if not placed_source:
            cls = str(rng.choice(["voltage.dc", "voltage.ac", "current.dc"]))
            placed_source = True
        else:
            cls = str(rng.choice(COMPONENT_CLASSES))
        cy = int((y0 + y1) // 2 + rng.integers(-12, 13))
        place_component(cls, int(rx) + t // 2, cy)

    # sometimes a component ON a rail (cuts the rail into two nets)
    if rng.random() < 0.5 and len(rail_ys) >= 2:
        ry = int(rng.choice(rail_ys))
        cx = int(rng.integers(x_left + 80, x_right - 80))
        place_component(str(rng.choice(COMPONENT_CLASSES)), cx, ry + t // 2)

    # gnd stub hanging from the bottom rail
    if rng.random() < 0.7:
        gx = int(rng.integers(x_left + 40, x_right - 40))
        gy0 = rail_ys[-1]
        gy1 = min(h - 12, gy0 + int(rng.integers(30, 55)))
        vwire(gx, gy0, gy1)
        place_component("gnd", gx + t // 2, gy1)

    # dangling terminal stub (single-net 'terminal' → type-N line)
    if rng.random() < 0.6:
        ty = int(rng.choice(rail_ys))
        tx1 = min(w - 12, x_right + int(rng.integers(10, 25)))
        hwire(ty, x_right, tx1)
        place_component("terminal", tx1, ty + t // 2)

    # junction glyph box (preserved in subtraction). Junction ONLY: a
    # "crossover" label here was detection-GT noise — the glyph renderer
    # draws a solder dot for junctions and nothing for crossovers, so a
    # labeled crossover was pixel-identical to every UNLABELED bare
    # intersection in the ladder and the detector (correctly) learned to
    # ignore it (AP@50 0.003). The crossover class itself stays covered
    # by the hand-built synth circuits and the topology preserve-set
    # tests; these randomized labels exist to exercise the
    # topology→netlist chain, where both classes are NETLIST_IGNORE.
    if rng.random() < 0.5:
        jx = int(rng.choice(rung_xs)) if len(rung_xs) else x_left + 100
        jy = int(rng.choice(rail_ys))
        boxes.append(
            BBox(
                class_name="junction",
                confidence=0.9,
                xmin=jx - 6, ymin=jy - 6, xmax=jx + 8, ymax=jy + 8,
            )
        )

    # text boxes (ignored by netlist, used by crop scoring elsewhere)
    for _ in range(int(rng.integers(0, 3))):
        tx = int(rng.integers(20, w - 60))
        ty2 = int(rng.integers(20, h - 30))
        boxes.append(
            BBox(
                class_name="text", confidence=0.85,
                xmin=tx, ymin=ty2, xmax=tx + int(rng.integers(20, 50)),
                ymax=ty2 + int(rng.integers(8, 16)),
            )
        )

    # noise specks, some with areas near the 4e-4 relative threshold
    # (4e-4 · H · W ≈ 80-250 px² here)
    for _ in range(int(rng.integers(0, 8))):
        side = int(rng.integers(2, 18))
        sx = int(rng.integers(5, w - side - 5))
        sy = int(rng.integers(5, h - side - 5))
        mask[sy : sy + side, sx : sx + side] = 255

    return mask, boxes


def random_circuits(n: int, seed0: int = 1000) -> list[tuple[np.ndarray, list[BBox]]]:
    return [random_circuit(seed0 + i) for i in range(n)]


def random_reclassify_scene(seed: int) -> tuple[np.ndarray, list[BBox]]:
    """One random RENDERED image + detections for differential testing of
    terminal reclassification (src/circuit_analyzer.py:2217-2311).

    Unlike random_circuit this returns an IMAGE (white background, black
    strokes) because the reclassify stage starts from segment_circuit's
    adaptive threshold of the original image, not from an oracle mask.
    Terminals are placed in three regimes: mid-wire (two contour stubs
    after box subtraction → reclassified to voltage.dc), wire-end (one
    stub → kept), and isolated (zero → kept); plus non-terminal
    components whose boxes get subtracted, and junction boxes that don't.
    """
    rng = np.random.default_rng(seed)
    h = int(rng.choice([360, 420]))
    w = int(rng.choice([520, 600]))
    t = int(rng.integers(2, 5))
    img = np.full((h, w, 3), 255, np.uint8)
    boxes: list[BBox] = []

    def hline(y, x0, x1):
        img[y : y + t, min(x0, x1) : max(x0, x1)] = 0

    def vline(x, y0, y1):
        img[min(y0, y1) : max(y0, y1), x : x + t] = 0

    def add_box(cls, cx, cy, bw, bh):
        b = BBox(
            class_name=cls,
            confidence=round(float(rng.uniform(0.5, 0.99)), 2),
            xmin=int(cx - bw // 2), ymin=int(cy - bh // 2),
            xmax=int(cx + bw // 2), ymax=int(cy + bh // 2),
        )
        boxes.append(b)
        return b

    # Three long horizontal wires, well separated.
    wire_ys = [60 + i * ((h - 120) // 2) for i in range(3)]
    for y in wire_ys:
        hline(y, 40, w - 40)

    # Mid-wire terminals (expected reclassified): box straddles the wire.
    for _ in range(int(rng.integers(1, 3))):
        y = int(rng.choice(wire_ys))
        cx = int(rng.integers(120, w - 120))
        add_box("terminal", cx, y + t // 2, int(rng.integers(24, 40)),
                int(rng.integers(24, 40)))

    # Wire-end terminal (single stub → kept as terminal).
    y = int(rng.choice(wire_ys))
    add_box("terminal", 40, y + t // 2, 30, 30)

    # Isolated terminal far from any stroke.
    add_box("terminal", w - 60, h - 30, 24, 24)

    # A couple of non-terminal components on wires (subtracted boxes).
    for _ in range(int(rng.integers(1, 4))):
        y = int(rng.choice(wire_ys))
        cx = int(rng.integers(100, w - 100))
        add_box(str(rng.choice(["resistor", "capacitor", "voltage.dc"])),
                cx, y + t // 2, int(rng.integers(30, 50)),
                int(rng.integers(30, 50)))

    # Junction glyph (box preserved during subtraction).
    if rng.random() < 0.5:
        y = int(rng.choice(wire_ys))
        add_box("junction", int(rng.integers(80, w - 80)), y + t // 2, 12, 12)

    # A vertical stub crossing one wire (extra contours).
    if rng.random() < 0.7:
        x = int(rng.integers(100, w - 100))
        y = int(rng.choice(wire_ys))
        vline(x, y - int(rng.integers(20, 50)), y + int(rng.integers(20, 50)))

    return img, boxes
