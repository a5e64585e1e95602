"""Hand-drawn-style synthetic schematics: the JAX package's
`eval/handdrawn.py`, byte for byte.

The reference's core domain is photos of hand-drawn circuits
(the reference's README: its SAM2 fine-tune set is 267 real
images; sample photos ship at its static/images/). The straight-ruler
renders of eval/synth.py and eval/glyphs.py never exercise that look.
This module draws each wire as a *hand stroke*: a quadratic bezier with
smooth perpendicular jitter, slowly varying width, and per-stroke ink
intensity — the three signatures of pen-on-paper drawing — and reuses
the class-distinct glyph/value grammar on top.

This is a generator (ground truth by construction: the mask is the
union of drawn wire strokes), distinct from the eval/degrade.py
"wobble" *corruption* which warps an already-rendered image. Used as

  * an eval category (`handdrawn_*` circuits in eval/synth.py), and
  * a training-pool augmentation for the detector/segmenter
    (scripts/train_yolo_demo.py, scripts/train_sam2_seg.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.types import BBox
from .glyphs import render_schematic
from .randomized import COMPONENT_CLASSES


def _clip(v, lo, hi):
    return max(lo, min(hi, int(v)))


def hand_stroke(
    image: np.ndarray,
    mask: Optional[np.ndarray],
    p0: tuple,
    p1: tuple,
    rng: np.random.Generator,
    width: float = 3.0,
    ink: int = 0,
) -> None:
    """Draw one pen stroke from p0 to p1 into `image` (and `mask`).

    Path = quadratic bezier whose control point is offset perpendicular
    to the chord (curvature), plus two low-frequency sinusoids of
    perpendicular jitter (wobble); width varies slowly along the stroke
    (pressure); `ink` is the stroke's gray level (pen darkness)."""
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    length = max(1.0, np.hypot(x1 - x0, y1 - y0))
    # unit perpendicular to the chord
    px, py = -(y1 - y0) / length, (x1 - x0) / length

    bow = float(rng.normal(0.0, length * 0.015))  # curvature
    amp1 = float(rng.uniform(0.4, 1.6))  # jitter harmonics
    amp2 = float(rng.uniform(0.2, 0.8))
    ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
    f1 = float(rng.uniform(1.5, 3.0))
    f2 = float(rng.uniform(4.0, 7.0))

    n = int(length * 2) + 2
    t = np.linspace(0.0, 1.0, n)
    # bezier with control at midpoint + bow * perp
    mx, my = (x0 + x1) / 2 + px * bow, (y0 + y1) / 2 + py * bow
    bx = (1 - t) ** 2 * x0 + 2 * (1 - t) * t * mx + t**2 * x1
    by = (1 - t) ** 2 * y0 + 2 * (1 - t) * t * my + t**2 * y1
    wob = amp1 * np.sin(2 * np.pi * f1 * t + ph1) + amp2 * np.sin(
        2 * np.pi * f2 * t + ph2
    )
    xs = bx + px * wob
    ys = by + py * wob
    # width varies slowly along the stroke (pen pressure)
    wph = float(rng.uniform(0, 2 * np.pi))
    ws = width + 0.8 * np.sin(2 * np.pi * 1.3 * t + wph)

    h, w = image.shape[:2]
    for x, y, sw in zip(xs, ys, ws):
        r = max(1, int(round(sw / 2)))
        yy0, yy1 = _clip(y - r, 0, h), _clip(y + r + 1, 0, h)
        xx0, xx1 = _clip(x - r, 0, w), _clip(x + r + 1, 0, w)
        if yy1 <= yy0 or xx1 <= xx0:
            continue
        image[yy0:yy1, xx0:xx1] = ink
        if mask is not None:
            mask[yy0:yy1, xx0:xx1] = 255


#: pen inks for photo-style renders (RGB) — black, red ballpoint, blue
_INKS = ((0, 0, 0), (165, 25, 45), (25, 35, 135), (40, 40, 40))
#: paper tints — white, warm white, legal-pad yellow (circuits_1.jpg)
_PAPERS = ((255, 255, 255), (250, 247, 238), (222, 218, 100))


def handdrawn_circuit(
    seed: int,
    with_values: bool = True,
    direction_overrides_classes: Optional[dict] = None,
    style: str = "clean",
):
    """One hand-drawn-style circuit (ladder or Wheatstone-style bridge
    with diagonal strokes).

    Returns (image, mask, boxes, values_by_uid, directions_by_uid,
    text_boxes): glyph semantics identical to
    glyphs.render_schematic, but the wires are hand strokes and the GT
    wire mask is the union of the drawn stroke pixels (ground truth by
    construction, not a warped straight-line raster).

    direction_overrides_classes: {class: (direction, reason)} canned
    stage-1 map — polarity marks are drawn to agree with it (the eval
    set pins directions class-level for the frozen VLM).

    style: "clean" = black ink on white (the pinned eval category);
    "photo" = random ink color, paper tint, and notebook ruling lines
    (which the GT mask EXCLUDES — the segmenter must learn to reject
    them, the exact skill the reference's hand-drawn photo domain needs,
    the reference's static/images/circuits_1.jpg)."""
    rng = np.random.default_rng(seed)
    h = int(rng.choice([420, 520, 620]))
    w = int(rng.choice([560, 700, 820]))
    width = float(rng.uniform(2.2, 4.2))
    if style == "photo":
        ink_rgb = np.asarray(_INKS[int(rng.integers(0, len(_INKS)))], np.uint8)
        paper = np.asarray(_PAPERS[int(rng.integers(0, len(_PAPERS)))], np.uint8)
    else:
        ink_rgb = np.asarray((0, 0, 0), np.uint8)
        paper = np.asarray((255, 255, 255), np.uint8)
    image = np.empty((h, w, 3), np.uint8)
    image[:] = paper
    if style == "photo" and rng.random() < 0.6:
        # notebook ruling: faint horizontal lines, image-only (not mask)
        rule = np.asarray((168, 200, 168), np.uint8)
        gap = int(rng.integers(32, 56))
        for y in range(int(rng.integers(0, gap)), h, gap):
            image[y : y + 2] = rule
    mask = np.zeros((h, w), np.uint8)
    boxes: list[BBox] = []
    ink = int(rng.integers(0, 55))  # pen darkness varies per drawing

    def stroke(p0, p1):
        hand_stroke(image, mask, p0, p1, rng, width=width, ink=ink)

    if rng.random() < 0.3:
        return _bridge_circuit(
            seed, rng, image, mask, boxes, stroke, with_values,
            direction_overrides_classes, ink_rgb, style,
        )

    # rails (drawn in 1-2 strokes each, like a pen lift mid-line)
    n_rails = int(rng.integers(2, 4))
    margin = 70
    rail_ys = [margin + int(rng.integers(0, 25))]
    for _ in range(n_rails - 1):
        nxt = rail_ys[-1] + int(rng.integers(110, 170))
        if nxt > h - margin:
            break
        rail_ys.append(nxt)
    if len(rail_ys) < 2:
        rail_ys = [margin, min(h - margin, margin + 150)]
    n_rails = len(rail_ys)
    x_left = int(rng.integers(35, 70))
    x_right = int(w - rng.integers(35, 70))
    for y in rail_ys:
        if rng.random() < 0.35:  # pen lift: two overlapping strokes
            xm = (x_left + x_right) // 2 + int(rng.integers(-40, 40))
            stroke((x_left, y), (xm + 6, y))
            stroke((xm - 6, y), (x_right, y))
        else:
            stroke((x_left, y), (x_right, y))

    def place(cls: str, cx: int, cy: int):
        bw = int(rng.integers(40, 66))
        bh = int(rng.integers(44, 72))
        b = BBox(
            class_name=cls,
            confidence=round(float(rng.uniform(0.5, 0.99)), 2),
            xmin=int(cx - bw // 2), ymin=int(cy - bh // 2),
            xmax=int(cx + bw // 2), ymax=int(cy + bh // 2),
        )
        boxes.append(b)
        return b

    # component rungs between adjacent rails
    n_rungs = max(2 * (n_rails - 1), int(rng.integers(2, 6)))
    rung_xs = [x_left + 70 + int(rng.integers(0, 30))]
    while len(rung_xs) < n_rungs and rung_xs[-1] + 120 < x_right - 70:
        rung_xs.append(rung_xs[-1] + int(rng.integers(85, 130)))
    placed_source = False
    for i, rx in enumerate(rung_xs):
        lo = i % (n_rails - 1)
        y0, y1 = rail_ys[lo], rail_ys[lo + 1]
        stroke((rx, y0), (rx, y1 + 2))
        cls = (
            str(rng.choice(["voltage.dc", "voltage.ac", "current.dc"]))
            if not placed_source
            else str(rng.choice(COMPONENT_CLASSES))
        )
        placed_source = True
        place(cls, rx, (y0 + y1) // 2 + int(rng.integers(-10, 11)))

    # gnd stub from the bottom rail
    if rng.random() < 0.7:
        gx = int(rng.integers(x_left + 50, x_right - 50))
        gy1 = min(h - 14, rail_ys[-1] + int(rng.integers(35, 60)))
        stroke((gx, rail_ys[-1]), (gx, gy1))
        place("gnd", gx, gy1)

    return _finish(
        rng, image, mask, boxes, with_values, direction_overrides_classes,
        ink_rgb, style,
    )


def _finish(rng, image, mask, boxes, with_values,
            direction_overrides_classes, ink_rgb, style):
    """Glyphs + values on the stroked base, then ink colorization."""
    dir_overrides = None
    if direction_overrides_classes is not None:
        valid = {"UP", "DOWN", "LEFT", "RIGHT"}
        dir_overrides = {
            b.persistent_uid: direction_overrides_classes[b.class_name][0]
            for b in boxes
            if b.class_name in direction_overrides_classes
            and direction_overrides_classes[b.class_name][0] in valid
        }
    img, values, directions, text_boxes = render_schematic(
        mask, boxes, rng, with_values=with_values, base_image=image,
        direction_overrides=dir_overrides,
    )
    if style == "photo" and tuple(int(c) for c in ink_rgb) != (0, 0, 0):
        # Glyph/text primitives draw near-black; recolor all dark ink to
        # the pen color so the whole drawing is one pen.
        dark = img.sum(axis=-1) < 170
        img[dark] = ink_rgb
    return img, mask, boxes, values, directions, text_boxes


def _bridge_circuit(seed, rng, image, mask, boxes, stroke, with_values,
                    direction_overrides_classes, ink_rgb, style):
    """Wheatstone-style diamond: four diagonal arms, a middle bridge
    element, and a source column on the left
    (the reference's static/images/Unbalanced_Wheatstone_bridge.png)."""
    h, w = image.shape[:2]
    cx = int(w * 0.58)
    cy = h // 2
    r = int(min(w, h) * rng.uniform(0.28, 0.34))
    T, B = (cx, cy - r), (cx, cy + r)
    L, R = (cx - r, cy), (cx + r, cy)
    for p0, p1 in ((L, T), (T, R), (L, B), (B, R), (L, R)):
        stroke(p0, p1)
    # source column just left of the diamond: T → across → down → B.
    # Rails run at the diamond's own T/B heights and the column sits
    # within clustering distance of the left arms, so the box-driven
    # crop (pad 80, src/circuit_analyzer.py:1183-1232) keeps the loop.
    sx = max(30, L[0] - int(rng.integers(60, 90)))
    stroke(T, (sx, T[1]))
    stroke((sx, T[1]), (sx, B[1]))
    stroke((sx, B[1]), B)

    def mid(p, q):
        return (p[0] + q[0]) // 2, (p[1] + q[1]) // 2

    def place(cls, c, bw=None, bh=None):
        bw = bw or int(rng.integers(44, 64))
        bh = bh or int(rng.integers(44, 64))
        boxes.append(BBox(
            class_name=cls,
            confidence=round(float(rng.uniform(0.5, 0.99)), 2),
            xmin=int(c[0] - bw // 2), ymin=int(c[1] - bh // 2),
            xmax=int(c[0] + bw // 2), ymax=int(c[1] + bh // 2),
        ))

    for pair in ((L, T), (T, R), (L, B), (B, R)):
        place("resistor", mid(*pair))
    place("resistor", mid(L, R))  # the bridge element
    place(str(rng.choice(["voltage.dc", "voltage.battery"])),
          (sx, cy), bw=40, bh=70)
    return _finish(
        rng, image, mask, boxes, with_values, direction_overrides_classes,
        ink_rgb, style,
    )
