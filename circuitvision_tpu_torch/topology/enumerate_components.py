"""Visual ids of the electrical components.

Counterpart of `assign_visual_ids` in the JAX package's
`topology/enumerate_components.py` — the id half of the reference's
enumerate_components (src/circuit_analyzer.py:479-785). The ids come
from a sequential counter over the non-excluded boxes in input order;
the digit placement search, and the cv2-drawn image it produces for a
black-box VLM, never change an id and are not part of this package yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..core import taxonomy
from ..core.types import BBox


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
