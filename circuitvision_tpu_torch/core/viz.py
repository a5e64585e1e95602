"""Host-side visualisation and summary helpers, drawn without cv2.

Counterpart of the JAX package's `core/viz.py` (reference
src/utils.py:109-122, 363-408; src/circuit_analyzer.py:415-458,
1584-1603), which draws with cv2. Here every drawing goes through
core/draw.py, which reproduces the cv2 calls pixel for pixel, so each
image is byte-equal to the JAX package's:

  - create_annotated_image — green boxes, red class/confidence labels on
    a white strip;
  - summarize_components — "Detected: 2 Resistors, 1 Voltage Dc";
  - contour_viz, connection_points_viz, node_viz — the node stage's
    debug images.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from . import draw
from .types import BBox, Node

#: 15-color debug palette (src/circuit_analyzer.py:415-431)
BRIGHT_COLORS = [
    (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0), (0, 255, 255),
    (255, 0, 255), (255, 128, 0), (128, 0, 255), (0, 255, 128),
    (255, 192, 203), (173, 216, 230), (255, 165, 0), (127, 255, 212),
    (240, 230, 140), (255, 105, 180),
]


def create_annotated_image(image: np.ndarray, bboxes: Sequence[BBox]) -> np.ndarray:
    """Green boxes + red class/confidence labels on a white strip."""
    out = np.ascontiguousarray(image.copy())
    for b in bboxes:
        draw.rectangle(out, (b.xmin, b.ymin), (b.xmax, b.ymax), (0, 255, 0), 2)
        label = f"{b.class_name}: {b.confidence:.2f}"
        (tw, th), _ = draw.get_text_size(label, 0.5, 1)
        draw.rectangle(out, (b.xmin, b.ymin - th - 5), (b.xmin + tw, b.ymin),
                       (255, 255, 255), -1)
        draw.put_text(out, label, (b.xmin, b.ymin - 5), 0.5, (0, 0, 255), 1)
    return out


def summarize_components(bboxes: Sequence[BBox]) -> str:
    """'Detected: 2 Resistors, 1 Voltage Dc' summary line."""
    counts: dict[str, int] = {}
    for b in bboxes:
        name = b.class_name.replace(".", " ").title()
        counts[name] = counts.get(name, 0) + 1
    if not counts:
        return "Detected: nothing"
    parts = [f"{n} {name}{'s' if n > 1 else ''}" for name, n in counts.items()]
    return "Detected: " + ", ".join(parts)


def contour_viz(shape_hw: tuple[int, int], contours: Sequence) -> np.ndarray:
    """Colored wire-contour debug image (reference get_contours viz,
    src/circuit_analyzer.py:405-458): black canvas, each kept contour's
    CHAIN_APPROX_SIMPLE polygon drawn closed at thickness 2 in the
    15-color palette, its red id at the int-truncated moments centroid
    + (10, 10)."""
    h, w = shape_hw
    out = np.zeros((h, w, 3), np.uint8)
    for i, ct in enumerate(contours):
        color = BRIGHT_COLORS[i % len(BRIGHT_COLORS)]
        cx, cy = ct.centroid if ct.m00 != 0 else (0, 0)  # reference :449-451
        draw.draw_contours(out, [np.asarray(ct.vertices, np.int64)], color, 2)
        draw.put_text(out, str(i), (int(cx) + 10, int(cy) + 10), 0.5, (255, 0, 0), 2)
    return out


def node_viz(resized_mask_u8: np.ndarray, nodes: Sequence[Node],
             contour_by_label: dict) -> np.ndarray:
    """Final node visualisation (reference src/circuit_analyzer.py:
    1584-1599): the resized (pre-enhance) emptied mask as RGB, each final
    node's contour drawn green at thickness 2 with its renumbered id in
    red at (cx − 10, cy + 10), scale 0.9 — skipped for zero-area
    contours, like the m00 guard."""
    base = np.ascontiguousarray(np.stack([np.asarray(resized_mask_u8, np.uint8)] * 3, axis=-1))
    for node in nodes:
        ct = contour_by_label.get(node.label)
        if ct is None or ct.m00 == 0:
            continue
        cx, cy = ct.centroid
        draw.draw_contours(base, [np.asarray(ct.vertices, np.int64)], (0, 255, 0), 2)
        draw.put_text(base, str(node.id), (int(cx) - 10, int(cy) + 10), 0.9, (0, 0, 255), 2)
    return base


def connection_points_viz(contour_img: np.ndarray,
                          points: Sequence[tuple[int, int]]) -> np.ndarray:
    """Contour visualisation + filled cyan circles of radius 5 at every
    terminal contact point (reference src/circuit_analyzer.py:1598-1601)."""
    out = np.ascontiguousarray(contour_img.copy())
    for x, y in points:
        draw.circle(out, (int(x), int(y)), 5, (0, 255, 255), -1)
    return out
