"""Cluster-based intelligent crop.

Re-implements crop_image_and_adjust_bboxes (src/circuit_analyzer.py:937-1284):
proximity-graph clustering of detections, text-association cluster scoring,
padding, text-window expansion, and bbox shifting/clipping. This is pure
box arithmetic on at most a few dozen detections — host logic by design;
the crop itself is a slice applied before the SAM2 device stage.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from ..core import geometry, taxonomy
from ..core.config import CropConfig
from ..core.types import BBox, CropInfo


def _clusters(elements: Sequence[BBox], threshold: int) -> list[list[int]]:
    """Connected components of the proximity graph (reference DFS,
    :1027-1050)."""
    n = len(elements)
    adj: list[list[int]] = [[] for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            if geometry.bboxes_proximal(elements[i], elements[j], threshold):
                adj[i].append(j)
                adj[j].append(i)
    visited = [False] * n
    clusters = []
    for i in range(n):
        if visited[i]:
            continue
        stack, members = [i], []
        while stack:
            u = stack.pop()
            if visited[u]:
                continue
            visited[u] = True
            members.append(u)
            for v in adj[u]:
                if not visited[v]:
                    stack.append(v)
        if members:
            clusters.append(members)
    return clusters


def _avg_diag(boxes: Sequence[BBox]) -> float:
    avg_w = sum(b.width for b in boxes) / len(boxes)
    avg_h = sum(b.height for b in boxes) / len(boxes)
    return math.sqrt(avg_w**2 + avg_h**2)


def crop_image_and_adjust_bboxes(
    image: np.ndarray,
    bboxes: Sequence[BBox],
    cfg: Optional[CropConfig] = None,
) -> tuple[np.ndarray, list[BBox], CropInfo]:
    """Crop to the main circuit cluster; adjust boxes into crop space.

    Returns (image, adjusted bboxes, CropInfo). When no crop applies the
    original image and copied boxes are returned with the reason recorded
    (every early-exit in the reference maps to a `reason_for_no_crop`).
    """
    cfg = cfg or CropConfig()
    h, w = image.shape[:2]
    info = CropInfo(original_dims=(w, h), cropped_dims=(w, h))

    text_boxes = [b for b in bboxes if b.class_name == "text"]
    elements = [b for b in bboxes if b.class_name not in taxonomy.CROP_CLUSTER_EXCLUDE]

    if not elements:
        info.reason_for_no_crop = "no_elements_for_clustering"
        info.decision_source = "no_crop_due_to_no_clustering_elements"
        return image, [b for b in bboxes], info

    # Adaptive proximity threshold (:1001-1023).
    non_junction = [b for b in elements if b.class_name != "junction"]
    avg_diag = 0.0
    if non_junction:
        avg_diag = _avg_diag(non_junction)
        threshold = max(int(avg_diag * cfg.cluster_multiplier), cfg.cluster_min_threshold)
    else:
        # junction-only cluster (reference :1014-1023); `elements` is
        # non-empty here — the empty case returned above.
        avg_diag = _avg_diag(elements)
        threshold = max(
            int(avg_diag * cfg.cluster_multiplier_junction_only),
            cfg.cluster_min_threshold_junction_only,
        )
    info.clustering_threshold = threshold

    clusters = _clusters(elements, threshold)
    info.num_clusters = len(clusters)

    if not clusters:
        basis = (
            min(b.xmin for b in elements),
            min(b.ymin for b in elements),
            max(b.xmax for b in elements),
            max(b.ymax for b in elements),
        )
        info.decision_source = "union_of_isolated_elements_for_clustering"
    else:
        # Score by (#text-associated non-junction components, cluster size)
        # (:1064-1094).
        text_prox = max(int((avg_diag if avg_diag > 0 else 30) * cfg.text_assoc_multiplier), cfg.text_assoc_min)
        scored = []
        for ci, members in enumerate(clusters):
            cluster_boxes = [elements[i] for i in members]
            actual = [b for b in cluster_boxes if b.class_name != "junction"]
            assoc = sum(
                1
                for b in actual
                if any(geometry.bboxes_proximal(b, t, text_prox) for t in text_boxes)
            )
            scored.append(
                {
                    "id": ci,
                    "boxes": cluster_boxes,
                    "score": (assoc, len(cluster_boxes)),
                    "text_assoc": assoc,
                    "actual": len(actual),
                }
            )
        scored.sort(key=lambda s: s["score"], reverse=True)

        if scored[0]["text_assoc"] == 0 and scored[0]["actual"] > 0:
            # Best has components but no text: fall back to largest cluster
            # by total element count (:1111-1126).
            main = max((s["boxes"] for s in scored), key=len)
            info.decision_source = "main_cluster_fallback_no_text_assoc_in_best_with_components"
        else:
            main = scored[0]["boxes"]
            info.decision_source = "main_yolo_cluster_scored_by_text_assoc"

        basis = (
            min(b.xmin for b in main),
            min(b.ymin for b in main),
            max(b.xmax for b in main),
            max(b.ymax for b in main),
        )

    info.basis_bbox = basis
    bx0, by0, bx1, by1 = basis

    # Skip crop when the basis already spans >90% of the image (:1171-1181).
    basis_area = max(0, bx1 - bx0) * max(0, by1 - by0)
    if h * w > 0 and basis_area / float(h * w) > cfg.skip_crop_area_fraction:
        info.reason_for_no_crop = "crop_basis_bbox_too_large"
        return image, [b for b in bboxes], info

    cx0 = float(max(0, bx0 - cfg.padding))
    cy0 = float(max(0, by0 - cfg.padding))
    cx1 = float(min(w, bx1 + cfg.padding))
    cy1 = float(min(h, by1 + cfg.padding))

    # Expand for nearby text boxes (:1193-1232).
    for t in text_boxes:
        tx0, ty0, tx1, ty1 = float(t.xmin), float(t.ymin), float(t.xmax), float(t.ymax)
        far = cfg.text_far_check_padding
        if tx1 < cx0 - far or tx0 > cx1 + far or ty1 < cy0 - far or ty0 > cy1 + far:
            continue
        pad = cfg.text_inclusion_padding
        nx0 = min(cx0, max(0, tx0 - pad))
        ny0 = min(cy0, max(0, ty0 - pad))
        nx1 = max(cx1, min(w, tx1 + pad))
        ny1 = max(cy1, min(h, ty1 + pad))
        if (nx0, ny0, nx1, ny1) != (cx0, cy0, cx1, cy1):
            info.text_expansions.append(t.persistent_uid)
        cx0, cy0, cx1, cy1 = nx0, ny0, nx1, ny1

    x0 = max(0, int(round(cx0)))
    y0 = max(0, int(round(cy0)))
    x1 = min(w, int(round(cx1)))
    y1 = min(h, int(round(cy1)))
    info.window = (x0, y0, x1, y1)

    if x0 >= x1 or y0 >= y1:
        info.reason_for_no_crop = "invalid_region_after_expansion"
        return image, [b for b in bboxes], info

    cropped = image[y0:y1, x0:x1]
    ch, cw = cropped.shape[:2]
    info.cropped_dims = (cw, ch)
    info.applied = True

    adjusted = []
    for b in bboxes:
        nb = b.shifted_clipped(x0, y0, cw, ch)
        if nb is not None:
            adjusted.append(nb)
    return cropped, adjusted, info
