"""Evaluation metrics: detection mAP and segmentation quality.

A copy of the JAX package's `eval/metrics.py` (numpy only), so that the
port reports fidelity on the card without the JAX package; the rest of
`eval/` is ROADMAP Queue A 10.

The reference publishes YOLOv11 mAP@50 = 0.9313 and fine-tuned SAM2
circuit-segmentation accuracy = 98.7% (README.md:113,119; BASELINE.md)
but ships no eval code. This module provides the measurement tools so
converted/retrained checkpoints can be scored against those numbers:

  - average_precision / map50: VOC-style AP with all-point interpolation
  - mask_iou / mask_accuracy / mask_dice: segmentation quality
  - netlist_exact_match: the build's own acceptance metric
    (BASELINE.json north star: netlist text exact-match on an eval set)
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.types import BBox


def _iou_matrix_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    inter_min = np.maximum(a[:, None, :2], b[None, :, :2])
    inter_max = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(inter_max - inter_min, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def average_precision(
    pred_boxes: Sequence[np.ndarray],
    pred_scores: Sequence[np.ndarray],
    gt_boxes: Sequence[np.ndarray],
    iou_threshold: float = 0.5,
) -> float:
    """Single-class AP over a set of images (all-point interpolation).

    pred_boxes[i]: (Ni, 4) xyxy; pred_scores[i]: (Ni,); gt_boxes[i]: (Mi, 4).
    """
    records = []  # (score, is_tp)
    total_gt = 0
    for pb, ps, gb in zip(pred_boxes, pred_scores, gt_boxes):
        pb, ps, gb = np.asarray(pb, float), np.asarray(ps, float), np.asarray(gb, float)
        total_gt += len(gb)
        if len(pb) == 0:
            continue
        order = np.argsort(-ps)
        pb, ps = pb[order], ps[order]
        matched = np.zeros(len(gb), bool)
        ious = _iou_matrix_np(pb, gb)
        for di in range(len(pb)):
            best_j, best_iou = -1, iou_threshold
            for gj in range(len(gb)):
                if not matched[gj] and ious[di, gj] >= best_iou:
                    best_j, best_iou = gj, ious[di, gj]
            if best_j >= 0:
                matched[best_j] = True
                records.append((ps[di], 1))
            else:
                records.append((ps[di], 0))
    if total_gt == 0:
        return 0.0
    if not records:
        return 0.0
    records.sort(key=lambda r: -r[0])
    tps = np.cumsum([r[1] for r in records])
    fps = np.cumsum([1 - r[1] for r in records])
    recall = tps / total_gt
    precision = tps / np.maximum(tps + fps, 1e-12)
    # all-point interpolation (COCO/VOC2010 style)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def map50(
    predictions: Sequence[Sequence[BBox]],
    ground_truth: Sequence[Sequence[BBox]],
    class_names: Optional[Sequence[str]] = None,
    iou_threshold: float = 0.5,
) -> dict:
    """mAP@IoU over BBox lists. Returns {'map': x, 'per_class': {...}}."""
    if class_names is None:
        class_names = sorted(
            {b.class_name for img in ground_truth for b in img}
        )
    per_class = {}
    for cls in class_names:
        pb = [
            np.asarray([[b.xmin, b.ymin, b.xmax, b.ymax] for b in img if b.class_name == cls]).reshape(-1, 4)
            for img in predictions
        ]
        ps = [
            np.asarray([b.confidence for b in img if b.class_name == cls])
            for img in predictions
        ]
        gb = [
            np.asarray([[b.xmin, b.ymin, b.xmax, b.ymax] for b in img if b.class_name == cls]).reshape(-1, 4)
            for img in ground_truth
        ]
        if sum(len(g) for g in gb) == 0:
            continue
        per_class[cls] = average_precision(pb, ps, gb, iou_threshold)
    mean = float(np.mean(list(per_class.values()))) if per_class else 0.0
    return {"map": mean, "per_class": per_class}


def mask_iou(pred: np.ndarray, target: np.ndarray) -> float:
    p = np.asarray(pred) > 0
    t = np.asarray(target) > 0
    union = np.logical_or(p, t).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(p, t).sum() / union)


def mask_accuracy(pred: np.ndarray, target: np.ndarray) -> float:
    """Pixel accuracy — the reference's published 98.7% segmentation
    metric is pixelwise (README.md:119)."""
    p = np.asarray(pred) > 0
    t = np.asarray(target) > 0
    return float((p == t).mean())


def mask_dice(pred: np.ndarray, target: np.ndarray) -> float:
    p = np.asarray(pred) > 0
    t = np.asarray(target) > 0
    denom = p.sum() + t.sum()
    if denom == 0:
        return 1.0
    return float(2.0 * np.logical_and(p, t).sum() / denom)


def netlist_exact_match(pred_texts: Sequence[str], ref_texts: Sequence[str]) -> float:
    """Fraction of netlists whose normalized text matches exactly
    (trailing-whitespace/blank-line insensitive)."""

    def norm(t: str) -> tuple:
        return tuple(line.rstrip() for line in t.strip().split("\n") if line.strip())

    if not ref_texts:
        return 0.0
    hits = sum(1 for p, r in zip(pred_texts, ref_texts) if norm(p) == norm(r))
    return hits / len(ref_texts)
