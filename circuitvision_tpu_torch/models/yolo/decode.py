"""Detector decoding: DFL expectation, anchor grids, class-aware NMS.

Counterpart of the JAX package's `models/yolo/decode.py`. Top-k by
best-class score, then greedy NMS with per-class box offsets (the
ultralytics trick), padded to `max_detections` rows with a valid mask.
"""
from __future__ import annotations

import torch

from ...ops.nms import greedy_nms

STRIDES = (8, 16, 32)


def _dfl(box_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """(..., 4*reg_max) → (..., 4) ltrb distances: softmax expectation."""
    logits = box_logits.reshape(*box_logits.shape[:-1], 4, reg_max)
    probs = torch.softmax(logits, dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=logits.device)
    return torch.sum(probs * bins, dim=-1)


def decode_predictions(head_outputs, reg_max: int = 16, num_classes: int = 62):
    """Per-scale head outputs → (boxes_xyxy (B, A, 4) px, scores (B, A, C))."""
    boxes_all, scores_all = [], []
    for out, stride in zip(head_outputs, STRIDES):
        b, h, w, _ = out.shape
        ltrb = _dfl(out[..., : 4 * reg_max], reg_max)
        dev = out.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, None, :]
        x0 = (xs - ltrb[..., 0]) * stride
        y0 = (ys - ltrb[..., 1]) * stride
        x1 = (xs + ltrb[..., 2]) * stride
        y1 = (ys + ltrb[..., 3]) * stride
        boxes_all.append(torch.stack([x0, y0, x1, y1], dim=-1).reshape(b, h * w, 4))
        scores_all.append(torch.sigmoid(out[..., 4 * reg_max :]).reshape(b, h * w, num_classes))
    return torch.cat(boxes_all, dim=1), torch.cat(scores_all, dim=1)


def postprocess(boxes, scores, max_detections: int = 128, conf_threshold: float = 0.25,
                iou_threshold: float = 0.7):
    """One image's (A, 4) boxes and (A, C) scores → (boxes, scores,
    classes, valid), each padded to max_detections rows."""
    best_score = scores.amax(dim=-1)
    best_class = scores.argmax(dim=-1)  # first maximum on ties, as jnp.argmax
    k = min(max_detections, best_score.shape[0])
    # stable descending sort == lax.top_k's tie order (lower index first)
    top_scores, top_idx = torch.sort(best_score, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    top_boxes = boxes[top_idx]
    top_classes = best_class[top_idx].to(torch.int32)
    valid = top_scores >= conf_threshold
    offset = top_classes.to(torch.float32)[:, None] * 7680.0
    keep = greedy_nms(top_boxes + offset, top_scores, valid, iou_threshold=iou_threshold)
    pad = max_detections - k
    if pad > 0:
        pad_rows = lambda t, *shape: torch.cat(  # noqa: E731
            [t, torch.zeros((pad, *shape), dtype=t.dtype, device=t.device)])
        top_boxes, top_scores = pad_rows(top_boxes, 4), pad_rows(top_scores)
        top_classes, keep = pad_rows(top_classes), pad_rows(keep)
    return top_boxes, top_scores, top_classes, keep


def unletterbox_boxes(boxes, scale: float, pads: tuple[float, float], orig_w: int, orig_h: int):
    """Map letterboxed-pixel boxes (N, 4) back to original image pixels.
    The scale and pads are f32 device tensors, so the division is a true
    f32 division on every device."""
    dev = boxes.device
    s = torch.tensor(scale, dtype=torch.float32, device=dev)
    p = torch.tensor(pads * 2, dtype=torch.float32, device=dev)
    hi = torch.tensor((orig_w, orig_h) * 2, dtype=torch.float32, device=dev)
    return torch.minimum(torch.clamp((boxes - p) / s, min=0.0), hi)
