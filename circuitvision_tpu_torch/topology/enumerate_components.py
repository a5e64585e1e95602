"""Visual ids of the electrical components, and the image that shows them.

Counterpart of the JAX package's `topology/enumerate_components.py`
(reference src/circuit_analyzer.py:479-785). `assign_visual_ids` is the
id half: a sequential counter over the non-excluded boxes in input
order, all that a box-driven reader needs. `enumerate_components` also
draws each id beside its component for a VLM that reads the whole image:
eight candidate positions around the component are tested against the
component itself, the other components, the static text boxes and the
ids already drawn; the nearest permissible one wins, and a two-step
fallback puts an id that fits nowhere near the component's top left or
the image's. The digits are drawn as the JAX package's cv2.putText draws
them (core/draw.put_text, which rasterises cv2's Rubik digit outlines,
core/rubik_digits.py, as cv2 does): a white halo at thickness + 2, then
the digits in the reference's (0, 0, 255) — blue on the RGB image. The
drawing was checked against cv2's for images up to `rubik_digits.MAX_ROWS`
(65500) rows; a taller one raises EnumerationSizeError before anything
is drawn.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from ..core import draw, rubik_digits, taxonomy
from ..core.types import BBox


class EnumerationSizeError(ValueError):
    """An image taller than the digits' drawing was checked at."""


def _overlap_area(a: tuple, b: tuple) -> int:
    ax0, ay0, ax1, ay1 = a
    bx0, by0, bx1, by1 = b
    iw = max(0, min(ax1, bx1) - max(ax0, bx0))
    ih = max(0, min(ay1, by1) - max(ay0, by0))
    return iw * ih


def _overlaps(rects: np.ndarray, others: np.ndarray) -> np.ndarray:
    """Per row of `rects` (x0, y0, x1, y1): whether it overlaps any row of
    `others` with a positive area (`_overlap_area` > 0)."""
    iw = np.minimum(rects[:, None, 2], others[None, :, 2]) - np.maximum(rects[:, None, 0],
                                                                          others[None, :, 0])
    ih = np.minimum(rects[:, None, 3], others[None, :, 3]) - np.maximum(rects[:, None, 1],
                                                                          others[None, :, 1])
    return ((iw > 0) & (ih > 0)).any(axis=1)


def _candidate_positions(b: BBox, tw: int, th: int) -> list[tuple[int, int]]:
    """Eight positions around the component (reference :602-612), in
    declaration order for tie stability."""
    pad = 5
    cx = b.xmin + b.width // 2
    cy = b.ymin + b.height // 2
    half_w, half_h = tw // 2, th // 2
    return [
        (b.xmax + pad, cy - half_h),  # right_middle
        (b.xmin - tw - pad, cy - half_h),  # left_middle
        (cx - half_w, b.ymin - th - pad),  # top_center
        (cx - half_w, b.ymax + pad),  # bottom_center
        (b.xmax + pad, b.ymin - th),  # top_right_corner_out
        (b.xmin - tw - pad, b.ymin - th),  # top_left_corner_out
        (b.xmax + pad, b.ymax),  # bottom_right_corner_out
        (b.xmin - tw - pad, b.ymax),  # bottom_left_corner_out
    ]


def _draw_number(img: np.ndarray, text: str, org: tuple[int, int], font_scale: float,
                 thickness: int) -> None:
    draw.put_text(img, text, org, font_scale, (255, 255, 255), thickness + 2)
    draw.put_text(img, text, org, font_scale, (0, 0, 255) if img.shape[-1] == 3 else 255,
                  thickness)


def assign_visual_ids(bboxes: Sequence[BBox],
                      excluded_labels: Optional[frozenset] = None) -> list[BBox]:
    excluded = excluded_labels if excluded_labels is not None else taxonomy.NON_COMPONENTS
    out_boxes: list[BBox] = []
    counter = 0
    for b in bboxes:
        if b.class_name in excluded:
            continue
        counter += 1
        out = dataclasses.replace(b)
        out.visual_id = counter
        out_boxes.append(out)
    return out_boxes


def enumerate_components(image: np.ndarray, bboxes: Sequence[BBox],
                         excluded_labels: Optional[frozenset] = None
                         ) -> tuple[np.ndarray, list[BBox]]:
    """Draw visual ids next to the electrical components. Returns (the
    drawn copy of `image`, the boxes with their visual ids)."""
    h, w = np.shape(image)[:2]
    if h > rubik_digits.MAX_ROWS:
        raise EnumerationSizeError(
            f"enumerate_components draws ids on images up to {rubik_digits.MAX_ROWS} rows "
            f"high, the tallest its digits were checked at (core/rubik_digits.py); "
            f"this one has {h}")
    img = np.array(image, copy=True, order="C")
    excluded = excluded_labels if excluded_labels is not None else taxonomy.NON_COMPONENTS

    # Font size tied to the image height (:495-496).
    font_scale = max(0.4, h / 900.0)
    thickness = int(max(1, h / 600.0))

    static_text_rects = []
    components = []
    for b in bboxes:
        if b.class_name in excluded:
            static_text_rects.append((b.xmin, b.ymin, b.xmax, b.ymax))
        else:
            components.append(b)

    # the overlap tests of every candidate against every rectangle at once
    comp_rects = np.array([(c.xmin, c.ymin, c.xmax, c.ymax) for c in components],
                          np.int64).reshape(-1, 4)
    static_rects = np.array(static_text_rects, np.int64).reshape(-1, 4)
    drawn_rects = np.zeros((len(components), 4), np.int64)
    uids = np.array([c.persistent_uid for c in components] + [None], dtype=object)[:-1]
    out_boxes: list[BBox] = []
    for counter, comp in enumerate(components, 1):
        text = str(counter)
        (tw, th), _ = draw.get_text_size(text, font_scale, thickness)
        comp_rect = (comp.xmin, comp.ymin, comp.xmax, comp.ymax)
        cx = comp.xmin + comp.width // 2
        cy = comp.ymin + comp.height // 2

        cand = np.array(_candidate_positions(comp, tw, th), np.int64)
        rects = np.concatenate([cand, cand + (tw, th)], axis=1)
        ok = (0 <= cand[:, 0]) & (cand[:, 0] < w - tw) & (0 <= cand[:, 1]) & (cand[:, 1] < h - th)
        ok &= ~_overlaps(rects, np.array([comp_rect], np.int64))
        ok &= ~_overlaps(rects, comp_rects[uids != comp.persistent_uid])
        ok &= ~_overlaps(rects, static_rects)
        ok &= ~_overlaps(rects, drawn_rects[:counter - 1])
        permissible = [(math.hypot(cx - (px + tw // 2), cy - (py + th // 2)), px, py)
                       for (px, py), good in zip(cand.tolist(), ok) if good]

        if permissible:
            permissible.sort(key=lambda p: p[0])
            _, x, y = permissible[0]
        else:
            # Fallback near the component's top-left (:736-755).
            x = max(0, min(comp.xmin + 3, w - tw))
            y = max(0, min(comp.ymin - th - 3, h - th))
            if _overlap_area((x, y, x + tw, y + th), comp_rect) > 0:
                x = max(0, min(5, w - tw))
                y = max(0, min(5 + (counter - 1) * (th + 2), h - th))

        _draw_number(img, text, (x, y + th), font_scale, thickness)
        drawn_rects[counter - 1] = (x, y, x + tw, y + th)
        out = dataclasses.replace(comp)
        out.visual_id = counter
        out_boxes.append(out)

    return img, out_boxes
