"""Host topology stage: outer-contour trace → polygon area filter →
vertex-walk touch matrix.

Counterpart of `contour_touch_stage_host` in the JAX package's
`topology/host_cc.py`, the production node-stage backend of both
packages. It reproduces the reference's get_contours + matching loop
semantics exactly (src/circuit_analyzer.py:388-459, 1380-1446): the area
filter uses the outer polygon area (holes included), components nested
in another's hole are not contours, centroids are int-truncated polygon
moments, and the terminal walk tests only the CHAIN_APPROX_SIMPLE
vertices.
"""
from __future__ import annotations

import numpy as np

from ..core.config import TopologyConfig
from .contours import trace_contours


def contour_touch_stage_host(
    fg: np.ndarray,  # (H, W) bool analysis raster (enhanced, binarized)
    width: float,  # true raster width (fg may carry right padding)
    cfg: TopologyConfig,
    comp_boxes: np.ndarray,  # (C, 4) float32 xmin,ymin,xmax,ymax
    comp_thr: np.ndarray,  # (C,) float32
    comp_valid: np.ndarray,  # (C,) bool
    area_threshold: float | None = None,
    broad_phase: bool = True,
):
    """cv2-exact host topology stage: outer-contour trace → polygon area
    filter → vertex-walk touch matrix.

    It reproduces the reference's get_contours + matching loop
    semantics exactly (src/circuit_analyzer.py:388-459, 1380-1446):

      * area filter uses cv2.contourArea — the OUTER POLYGON area, which
        includes holes (a wire ring's area is the enclosed disk, not the
        ring's pixel count);
      * components nested inside another component's hole are not
        contours at all (RETR_EXTERNAL);
      * centroids are Green's-theorem polygon moments, int-truncated;
      * the terminal walk tests ONLY the CHAIN_APPROX_SIMPLE vertices —
        a box whose edge strip crosses the middle of a straight wire run
        does NOT touch unless a direction-change vertex falls in it.

    Returns (centroids_int (K, 2), rel_area (K,), touch (K, C) bool,
    kept_contours) for the KEPT contours in cv2 enumeration order (node
    old-id order); ids are assigned post-filter exactly like get_contours
    (:410-412). `broad_phase=False` mirrors the reclassification walk
    (:2279-2287), which tests every contour with no rect pre-filter.
    """
    h = fg.shape[0]
    thr = cfg.contour_area_threshold if area_threshold is None else area_threshold
    normalizer = float(h) * float(width)
    kept = [c for c in trace_contours(fg) if c.area / normalizer > thr]

    C = len(comp_boxes)
    K = len(kept)
    centroids = np.zeros((K, 2), np.int64)
    rel_area = np.zeros(K, np.float32)
    touch = np.zeros((K, C), bool)
    vc = np.nonzero(np.asarray(comp_valid[:C]))[0]
    bx0, by0, bx1, by1 = (
        np.asarray(comp_boxes)[vc, i].astype(np.float64) for i in range(4)
    )
    t = np.asarray(comp_thr)[vc].astype(np.float64)
    for k, ct in enumerate(kept):
        centroids[k] = ct.centroid
        rel_area[k] = ct.area / normalizer
        if not len(vc):
            continue
        if broad_phase:
            # cv2.boundingRect is max-exclusive (+1), :1393-1401
            rx0, ry0, rx1, ry1 = ct.rect
            overlap = ~(
                (bx1 < rx0) | (bx0 > rx1 + 1.0) | (by1 < ry0) | (by0 > ry1 + 1.0)
            )
            if not overlap.any():
                continue
        else:
            overlap = np.ones(len(vc), bool)
        vx = ct.vertices[:, 0].astype(np.float64)[:, None]
        vy = ct.vertices[:, 1].astype(np.float64)[:, None]
        near = (
            ((vx >= bx0) & (vx <= bx1) & (vy >= by0) & (vy <= by1))
            | (np.abs(vx - bx0) <= t)
            | (np.abs(vx - bx1) <= t)
            | (np.abs(vy - by0) <= t)
            | (np.abs(vy - by1) <= t)
        )
        touch[k, vc] = overlap & near.any(axis=0)
    return centroids, rel_area, touch, kept
