"""YOLO detection loss: Task-Aligned assignment + CIoU + DFL + BCE.

Counterpart of the JAX package's `train/yolo_loss.py`, the ultralytics
v8 detection-loss formulation (TaskAlignedAssigner with topk 10, alpha
0.5, beta 6.0; CIoU box loss; Distribution Focal Loss on the ltrb bin
distributions; BCE against task-aligned soft targets; gains box 7.5,
cls 0.5, dfl 1.5), static-shape and vectorised over (B, M, A): ground
truth padded to (B, M) with a validity mask.

Where JAX stops a gradient (`jax.lax.stop_gradient`) the port detaches.
`jax.lax.top_k` breaks ties toward the lower index, and the exact-k
scatter exists for identical predictions; the port takes its top k from
a stable descending sort, which orders ties the same way (`torch.topk`'s
order on ties is unspecified on CUDA). argmax keeps the first maximum in
both.

Coordinates: boxes in input-image pixels (letterboxed space); anchor
centres at (x + 0.5)·stride, as models/yolo/decode.decode_predictions.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from ..models.yolo.decode import STRIDES, _dfl


@dataclasses.dataclass(frozen=True)
class YOLOLossConfig:
    """ultralytics v8DetectionLoss hyper-parameters."""

    num_classes: int = 62
    reg_max: int = 16
    img_size: int = 640
    #: TaskAlignedAssigner(topk, alpha, beta)
    topk: int = 10
    alpha: float = 0.5
    beta: float = 6.0
    #: loss gains (ultralytics default hyp: box, cls, dfl)
    gain_box: float = 7.5
    gain_cls: float = 0.5
    gain_dfl: float = 1.5
    eps: float = 1e-9


def anchor_grid(img_size: int, strides: Sequence[int] = STRIDES, device=None):
    """(A, 2) anchor centres in pixels and (A,) stride per anchor, in the
    flatten order of decode_predictions (row-major per scale, scales in
    stride order)."""
    pts, sts = [], []
    for s in strides:
        n = img_size // s
        r = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * s
        gy, gx = torch.meshgrid(r, r, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
        sts.append(torch.full((n * n,), float(s), dtype=torch.float32, device=device))
    return torch.cat(pts, dim=0), torch.cat(sts, dim=0)


def pairwise_ciou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Complete IoU between aligned boxes (…, 4) xyxy → (…,):
    IoU − ρ²/c² − αv, α outside the gradient (ultralytics)."""
    ax0, ay0, ax1, ay1 = boxes_a.unbind(-1)
    bx0, by0, bx1, by1 = boxes_b.unbind(-1)
    aw, ah = ax1 - ax0, ay1 - ay0
    bw, bh = bx1 - bx0, by1 - by0
    ix = torch.clamp(torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0), min=0.0)
    iy = torch.clamp(torch.minimum(ay1, by1) - torch.maximum(ay0, by0), min=0.0)
    inter = ix * iy
    union = aw * ah + bw * bh - inter
    iou = inter / (union + 1e-9)
    cw = torch.maximum(ax1, bx1) - torch.minimum(ax0, bx0)
    ch = torch.maximum(ay1, by1) - torch.minimum(ay0, by0)
    c2 = cw * cw + ch * ch + 1e-9
    rho2 = ((ax0 + ax1 - bx0 - bx1) ** 2 + (ay0 + ay1 - by0 - by1) ** 2) / 4.0
    v = (4.0 / torch.pi ** 2) * (torch.atan(bw / (bh + 1e-9)) - torch.atan(aw / (ah + 1e-9))) ** 2
    alpha = (v / (v - iou + 1.0 + 1e-9)).detach()
    return iou - rho2 / c2 - alpha * v


def iou_matrix_xyxy(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Plain IoU between (B, M, 4) gt and (B, A, 4) pred → (B, M, A)."""
    g = gt[:, :, None, :]
    p = pred[:, None, :, :]
    ix = torch.clamp(torch.minimum(g[..., 2], p[..., 2]) - torch.maximum(g[..., 0], p[..., 0]),
                     min=0.0)
    iy = torch.clamp(torch.minimum(g[..., 3], p[..., 3]) - torch.maximum(g[..., 1], p[..., 1]),
                     min=0.0)
    inter = ix * iy
    ga = (g[..., 2] - g[..., 0]) * (g[..., 3] - g[..., 1])
    pa = (p[..., 2] - p[..., 0]) * (p[..., 3] - p[..., 1])
    return inter / (ga + pa - inter + 1e-9)


def alignment_metric(pred_scores, pred_boxes, anchor_points, gt_boxes, gt_classes, gt_valid,
                     cfg: YOLOLossConfig):
    """(align, in_gt, iou), each (B, M, A): the task-aligned metric t =
    score^alpha · IoU^beta of every anchor for every GT (0 outside it),
    whether the anchor's centre lies inside the GT, and their IoU clamped
    at 0 — the quantities task_aligned_assign ranks and resolves by."""
    B, A, C = pred_scores.shape
    M = gt_boxes.shape[1]
    valid = gt_valid[..., None]
    ax = anchor_points[None, None, :, 0]
    ay = anchor_points[None, None, :, 1]
    in_gt = ((ax > gt_boxes[..., 0:1]) & (ax < gt_boxes[..., 2:3])
             & (ay > gt_boxes[..., 1:2]) & (ay < gt_boxes[..., 3:4])) & valid

    iou = torch.clamp(iou_matrix_xyxy(gt_boxes, pred_boxes), min=0.0)
    cls_idx = torch.clamp(gt_classes.long(), 0, C - 1)
    score = torch.gather(pred_scores.transpose(1, 2), 1, cls_idx[:, :, None].expand(B, M, A))
    align = (score ** cfg.alpha) * (iou ** cfg.beta)
    return torch.where(in_gt, align, torch.zeros_like(align)), in_gt, iou


def task_aligned_assign(pred_scores, pred_boxes, anchor_points, gt_boxes, gt_classes, gt_valid,
                        cfg: YOLOLossConfig):
    """Task-Aligned label assignment (TOOD/ultralytics).

    pred_scores (B, A, C) sigmoid scores, pred_boxes (B, A, 4) decoded
    xyxy pixels, anchor_points (A, 2), gt_boxes (B, M, 4), gt_classes
    (B, M) int, gt_valid (B, M) bool. Returns (fg_mask (B, A) bool,
    assigned_gt (B, A) int32, target_scores (B, A, C)). Per GT the
    candidates are the anchors whose centre lies inside it; the top k by
    alignment t = score^alpha · IoU^beta are assigned; an anchor claimed
    by several GTs keeps the highest-IoU one; its class target is the
    GT's class scaled by t / max_t(gt) · max_iou(gt)."""
    B, A, C = pred_scores.shape
    M = gt_boxes.shape[1]
    align, in_gt, iou = alignment_metric(pred_scores, pred_boxes, anchor_points, gt_boxes,
                                         gt_classes, gt_valid, cfg)
    cls_idx = torch.clamp(gt_classes.long(), 0, C - 1)

    # top-k candidates per gt, exact k (a `>= kth value` test would
    # over-select on exact ties); ties to the lower anchor index
    k = min(cfg.topk, A)
    topk_idx = torch.sort(align, dim=-1, descending=True, stable=True)[1][..., :k]
    cand = torch.zeros((B, M, A), dtype=torch.bool, device=align.device)
    cand.scatter_(2, topk_idx, True)
    cand = cand & in_gt & (align > 0.0)

    # conflict resolution: an anchor claimed by > 1 gt keeps the max-IoU gt
    claims = cand.sum(dim=1)
    iou_masked = torch.where(cand, iou, torch.full_like(iou, -1.0))
    best_gt = torch.argmax(iou_masked, dim=1)
    fg_mask = claims > 0
    only = F.one_hot(best_gt, M).permute(0, 2, 1).bool()
    cand = torch.where((claims > 1)[:, None, :], cand & only, cand)

    zero = torch.zeros_like(align)
    max_align = torch.amax(torch.where(cand, align, zero), dim=2, keepdim=True)
    max_iou = torch.amax(torch.where(cand, iou, zero), dim=2, keepdim=True)
    norm = align * max_iou / (max_align + cfg.eps)
    per_anchor_t = torch.amax(torch.where(cand, norm, zero), dim=1)

    assigned_gt = torch.argmax(cand.to(torch.uint8), dim=1)
    assigned_cls = torch.gather(cls_idx, 1, assigned_gt)
    target_scores = (F.one_hot(assigned_cls, C).to(pred_scores.dtype)
                     * per_anchor_t[..., None] * fg_mask[..., None])
    return fg_mask, assigned_gt.to(torch.int32), target_scores


def _dfl_loss(pred_dist: torch.Tensor, target_ltrb: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution focal loss: CE against the two bins bracketing the
    continuous target, per ltrb side, averaged over the 4 sides → (B, A)."""
    B, A, _ = pred_dist.shape
    logp = torch.log_softmax(pred_dist.reshape(B, A, 4, reg_max), dim=-1)
    t = torch.clamp(target_ltrb, 0.0, reg_max - 1 - 0.01)
    tl = torch.floor(t).long()
    tr = tl + 1
    wl = tr.to(t.dtype) - t
    wr = 1.0 - wl
    ce_l = -torch.gather(logp, -1, tl[..., None])[..., 0]
    ce_r = -torch.gather(logp, -1, torch.clamp(tr, 0, reg_max - 1)[..., None])[..., 0]
    return (wl * ce_l + wr * ce_r).mean(dim=-1)


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid binary cross-entropy (numerically stable), as
    the JAX package's `optax_sigmoid_bce`."""
    return torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def decode_heads(head_outputs, cfg: YOLOLossConfig):
    """Per-scale head outputs → (box logits (B, A, 4·reg_max), class
    logits (B, A, C), decoded boxes (B, A, 4) xyxy pixels, anchor centres
    (A, 2), strides (A,)), float32, through the inference DFL expectation."""
    R = cfg.reg_max
    flat = torch.cat([o.reshape(o.shape[0], -1, o.shape[-1]) for o in head_outputs],
                     dim=1).float()
    pred_dist = flat[..., :4 * R]
    anchor_points, strides_a = anchor_grid(cfg.img_size, device=flat.device)
    ltrb = _dfl(pred_dist, R)
    x0 = anchor_points[None, :, 0] - ltrb[..., 0] * strides_a[None]
    y0 = anchor_points[None, :, 1] - ltrb[..., 1] * strides_a[None]
    x1 = anchor_points[None, :, 0] + ltrb[..., 2] * strides_a[None]
    y1 = anchor_points[None, :, 1] + ltrb[..., 3] * strides_a[None]
    return (pred_dist, flat[..., 4 * R:], torch.stack([x0, y0, x1, y1], dim=-1), anchor_points,
            strides_a)


def yolo_detection_loss(head_outputs, gt_boxes, gt_classes, gt_valid, cfg: YOLOLossConfig):
    """Total loss and metrics {loss, box_loss, cls_loss, dfl_loss, n_fg}
    from the per-scale head outputs (B, Hs, Ws, 4·reg_max + C)."""
    R = cfg.reg_max
    pred_dist, pred_cls_logits, pred_boxes, anchor_points, strides_a = decode_heads(
        head_outputs, cfg)
    pred_scores = torch.sigmoid(pred_cls_logits)
    gt_f = gt_boxes.float()
    fg_mask, assigned_gt, target_scores = task_aligned_assign(
        pred_scores.detach(), pred_boxes.detach(), anchor_points, gt_f, gt_classes, gt_valid,
        cfg)
    ts_sum = torch.clamp(target_scores.sum(), min=1.0)

    cls_loss = sigmoid_bce(pred_cls_logits, target_scores).sum() / ts_sum

    tboxes = torch.gather(gt_f, 1, assigned_gt.long()[..., None].expand(-1, -1, 4))
    weight = target_scores.sum(dim=-1) * fg_mask
    ciou = pairwise_ciou(pred_boxes, tboxes)
    box_loss = ((1.0 - ciou) * weight).sum() / ts_sum

    t_ltrb = torch.stack([
        (anchor_points[None, :, 0] - tboxes[..., 0]) / strides_a[None],
        (anchor_points[None, :, 1] - tboxes[..., 1]) / strides_a[None],
        (tboxes[..., 2] - anchor_points[None, :, 0]) / strides_a[None],
        (tboxes[..., 3] - anchor_points[None, :, 1]) / strides_a[None],
    ], dim=-1)
    dfl_loss = (_dfl_loss(pred_dist, t_ltrb, R) * weight).sum() / ts_sum

    total = cfg.gain_box * box_loss + cfg.gain_cls * cls_loss + cfg.gain_dfl * dfl_loss
    metrics = {"loss": total, "box_loss": box_loss, "cls_loss": cls_loss,
               "dfl_loss": dfl_loss, "n_fg": fg_mask.sum()}
    return total, metrics
