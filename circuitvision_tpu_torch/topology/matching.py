"""Vectorized terminal-to-node matching on a label raster.

Counterpart of the JAX package's `topology/matching.py`:

  touch[k, c] = broad_phase(label k bbox, comp c bbox)
                AND exists boundary pixel p of label k with
                    point_near_bbox(p, comp c bbox, thr_c)

with the reference's `point_near_bbox` (src/circuit_analyzer.py:811-846),
core/geometry.near_box: inside the box, or within the class threshold of
any box edge LINE, measured per axis. JAX's existence test is one (K, HW) × (HW, C)
product; here it sums the near predicate over each boundary pixel's
label row with a scatter-add, which counts pixels and so gives the same
booleans in any order.
"""
from __future__ import annotations

import torch

from ..core.geometry import near_box


def touch_matrix(labels, boundary, uniq_labels, label_bboxes, label_valid,
                 comp_boxes, comp_thresholds, comp_valid) -> torch.Tensor:
    """labels (H, W) int label image, boundary (H, W) bool, uniq_labels
    (K,), label_bboxes (K, 4), label_valid (K,), comp_boxes (C, 4) f32,
    comp_thresholds (C,) f32, comp_valid (C,) bool → (K, C) bool: one
    raster of `touch_matrix_stack`."""
    return touch_matrix_stack(*(t[None] for t in (
        labels, boundary, uniq_labels, label_bboxes, label_valid, comp_boxes,
        comp_thresholds, comp_valid)))[0]


def touch_matrix_stack(labels, boundary, uniq_labels, label_bboxes, label_valid,
                       comp_boxes, comp_thresholds, comp_valid) -> torch.Tensor:
    """`touch_matrix` over a stack: labels (B, H, W), boundary (B, H, W),
    uniq_labels (B, K), label_bboxes (B, K, 4), label_valid (B, K),
    comp_boxes (B, C, 4), comp_thresholds (B, C), comp_valid (B, C) →
    (B, K, C) bool.

    The existence test sums, per label row, the near predicate of the
    label's boundary pixels with a scatter-add over each pixel's row
    instead of the (K, HW) one-hot product: the sums count pixels, so
    `> 0` is exact whatever the order. One raster at a time, so the
    (HW, C) predicate is the largest temporary."""
    b, h, w = labels.shape
    k = uniq_labels.shape[1]
    dev = labels.device
    ys = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)
    xs = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    px, py = xs[:, None], ys[:, None]
    out = []
    for i in range(b):
        bx0, by0, bx1, by1 = comp_boxes[i].unbind(1)
        near = near_box(px, py, bx0, by0, bx1, by1, comp_thresholds[i]) & comp_valid[i][None, :]
        # each boundary pixel's row among the K labels, K for the others
        rowmap = torch.full((h * w + 1,), k, dtype=torch.int64, device=dev)
        rowmap.scatter_(0, uniq_labels[i].to(torch.int64), torch.arange(k, device=dev))
        rowmap[h * w] = k
        row = rowmap[labels[i].reshape(-1).to(torch.int64)]
        row = torch.where(boundary[i].reshape(-1), row, k)
        contact = torch.zeros((k + 1, near.shape[1]), dtype=torch.float32, device=dev)
        contact.index_add_(0, row, near.to(torch.float32))
        out.append(contact[:k] > 0.0)
    contact = torch.stack(out)
    lx0, ly0, lx1, ly1 = label_bboxes.unbind(2)
    bx0, by0, bx1, by1 = comp_boxes.unbind(2)
    overlap = ~(
        (bx1[:, None, :] < lx0[..., None]) | (bx0[:, None, :] > lx1[..., None])
        | (by1[:, None, :] < ly0[..., None]) | (by0[:, None, :] > ly1[..., None])
    )
    return contact & overlap & label_valid[..., None] & comp_valid[:, None, :]
