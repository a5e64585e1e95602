"""Host-side box geometry: IoU, greedy NMS, proximity predicates.

Re-implements src/utils.py:297-361 (IoU + NMS variants) and the proximity
predicates used for clustering and terminal matching
(src/circuit_analyzer.py:811-846, 892-928). The batched device-side NMS
lives in ops/nms.py; these host versions operate on small BBox lists where
Python overhead is negligible.
"""
from __future__ import annotations

from typing import Sequence

from .types import BBox


def iou(a: BBox, b: BBox) -> float:
    """Intersection-over-union (src/utils.py:297-328)."""
    inter_xmin = max(a.xmin, b.xmin)
    inter_ymin = max(a.ymin, b.ymin)
    inter_xmax = min(a.xmax, b.xmax)
    inter_ymax = min(a.ymax, b.ymax)
    inter = max(inter_xmax - inter_xmin, 0) * max(inter_ymax - inter_ymin, 0)
    union = a.area + b.area - inter
    return inter / union if union > 0 else 0.0


def nms_by_confidence(bboxes: Sequence[BBox], iou_threshold: float = 0.5) -> list[BBox]:
    """Greedy NMS keeping the highest-confidence box (src/utils.py:346-361).

    Above a small size the greedy scan runs vectorized (the throughput
    bench feeds ~107 raw detector boxes per image; the per-pair Python
    walk costs a few ms/img on a 1-core host). Bit-identical to the
    reference loop: stable descending confidence sort (ties keep input
    order, like sorted(reverse=True)), integer box arithmetic exact in
    float64, same strict `iou < threshold` keep rule — pinned against the
    reference's own function on fuzzed inputs including ties
    (tests/test_reference_diff.py::TestHostUtilsMatchReference)."""
    if len(bboxes) < 24:
        remaining = sorted(bboxes, key=lambda b: b.confidence, reverse=True)
        kept: list[BBox] = []
        while remaining:
            best = remaining.pop(0)
            kept.append(best)
            remaining = [b for b in remaining if iou(best, b) < iou_threshold]
        return kept

    import numpy as np

    conf = np.asarray([b.confidence for b in bboxes], np.float64)
    order = np.argsort(-conf, kind="stable")
    coords = np.asarray(
        [[b.xmin, b.ymin, b.xmax, b.ymax] for b in bboxes], np.float64
    )[order]
    # BBox.area clamps each dimension to >= 0; degenerate boxes must
    # suppress identically on both the scalar and vectorized paths.
    areas = np.maximum(coords[:, 2] - coords[:, 0], 0.0) * np.maximum(
        coords[:, 3] - coords[:, 1], 0.0
    )
    n = len(order)
    alive = np.ones(n, bool)
    kept_order: list[int] = []
    for i in range(n):
        if not alive[i]:
            continue
        kept_order.append(i)
        js = np.nonzero(alive[i + 1 :])[0] + i + 1
        if js.size == 0:
            break
        iw = np.minimum(coords[i, 2], coords[js, 2]) - np.maximum(
            coords[i, 0], coords[js, 0]
        )
        ih = np.minimum(coords[i, 3], coords[js, 3]) - np.maximum(
            coords[i, 1], coords[js, 1]
        )
        inter = np.maximum(iw, 0.0) * np.maximum(ih, 0.0)
        union = areas[i] + areas[js] - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            ious = np.where(union > 0, inter / union, 0.0)
        alive[js[ious >= iou_threshold]] = False
    return [bboxes[order[i]] for i in kept_order]


def boxes_overlap(a: BBox, b: BBox) -> bool:
    return not (a.xmax < b.xmin or a.xmin > b.xmax or a.ymax < b.ymin or a.ymin > b.ymax)


def edge_distances(a: BBox, b: BBox) -> tuple[int, int]:
    """(h_dist, v_dist) between closest edges; 0 on overlap along an axis."""
    if a.xmax < b.xmin:
        h = b.xmin - a.xmax
    elif a.xmin > b.xmax:
        h = a.xmin - b.xmax
    else:
        h = 0
    if a.ymax < b.ymin:
        v = b.ymin - a.ymax
    elif a.ymin > b.ymax:
        v = a.ymin - b.ymax
    else:
        v = 0
    return h, v


def bboxes_proximal(a: BBox, b: BBox, threshold: int) -> bool:
    """Crop-clustering proximity (src/circuit_analyzer.py:892-928):
    overlap, or both edge distances within threshold."""
    if boxes_overlap(a, b):
        return True
    h, v = edge_distances(a, b)
    return h <= threshold and v <= threshold
