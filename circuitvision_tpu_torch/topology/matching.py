"""Vectorized terminal-to-node matching on a label raster.

Counterpart of the JAX package's `topology/matching.py`:

  touch[k, c] = broad_phase(label k bbox, comp c bbox)
                AND exists boundary pixel p of label k with
                    point_near_bbox(p, comp c bbox, thr_c)

with the reference's `point_near_bbox` (src/circuit_analyzer.py:811-846):
inside the box, or within the class threshold of any box edge LINE,
measured per axis. The existence test is one (K, HW) × (HW, C) product.
"""
from __future__ import annotations

import torch


def touch_matrix(labels, boundary, uniq_labels, label_bboxes, label_valid,
                 comp_boxes, comp_thresholds, comp_valid) -> torch.Tensor:
    """labels (H, W) int label image, boundary (H, W) bool, uniq_labels
    (K,), label_bboxes (K, 4), label_valid (K,), comp_boxes (C, 4) f32,
    comp_thresholds (C,) f32, comp_valid (C,) bool → (K, C) bool."""
    h, w = labels.shape
    dev = labels.device
    flat_labels = labels.reshape(-1)
    flat_boundary = boundary.reshape(-1)
    ys = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)
    xs = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    bx0, by0, bx1, by1 = comp_boxes.unbind(1)
    t = comp_thresholds
    px, py = xs[:, None], ys[:, None]
    inside = (px >= bx0) & (px <= bx1) & (py >= by0) & (py <= by1)
    near_edge = ((px - bx0).abs() <= t) | ((px - bx1).abs() <= t) | \
        ((py - by0).abs() <= t) | ((py - by1).abs() <= t)
    near = (inside | near_edge) & comp_valid[None, :]
    onehot = (flat_labels[None, :] == uniq_labels[:, None]) & flat_boundary[None, :]
    contact = (onehot.float() @ near.float()) > 0.0
    lx0, ly0, lx1, ly1 = label_bboxes.unbind(1)
    overlap = ~(
        (bx1[None, :] < lx0[:, None]) | (bx0[None, :] > lx1[:, None])
        | (by1[None, :] < ly0[:, None]) | (by0[None, :] > ly1[:, None])
    )
    return contact & overlap & label_valid[:, None] & comp_valid[None, :]
