"""Batched IoU and greedy NMS, written out (no torchvision).

Counterpart of the JAX package's `ops/nms.py`. The (N, N) IoU matrix is
one broadcast on the device; the greedy pass is inherently sequential
over N ≤ max_detections score-sorted rows, so it walks the fetched
matrix on the host instead of launching N tiny device steps.
"""
from __future__ import annotations

import numpy as np
import torch


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU, boxes as (N, 4) xyxy. Returns (N, M) float32."""
    a = boxes_a.to(torch.float32)
    b = boxes_b.to(torch.float32)
    inter_min = torch.maximum(a[:, None, :2], b[None, :, :2])
    inter_max = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(inter_max - inter_min, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[:, 2] - a[:, 0], min=0.0) * torch.clamp(a[:, 3] - a[:, 1], min=0.0)
    area_b = torch.clamp(b[:, 2] - b[:, 0], min=0.0) * torch.clamp(b[:, 3] - b[:, 1], min=0.0)
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def greedy_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float = 0.6,
) -> torch.Tensor:
    """Greedy highest-score-first NMS (semantics of src/utils.py:346-361).

    boxes (N,4), scores (N,), valid (N,) bool. Returns the keep mask (N,)
    bool, on the input's device, aligned with the *input* order. Ties in
    score keep input order (stable sort), as `jnp.argsort` does.
    """
    s = torch.where(valid, scores.to(torch.float32), -1.0)
    order = torch.argsort(-s, stable=True)
    ious = iou_matrix(boxes[order], boxes[order]).cpu().numpy()
    sorted_valid = valid[order].cpu().numpy()
    n = len(sorted_valid)
    keep_sorted = np.zeros(n, bool)
    suppressed = np.zeros(n, bool)
    for i in range(n):
        if not sorted_valid[i] or suppressed[i]:
            continue
        keep_sorted[i] = True
        suppressed[i + 1 :] |= ious[i, i + 1 :] >= iou_threshold
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = torch.from_numpy(keep_sorted).to(boxes.device)
    return keep
