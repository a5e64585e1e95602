"""Segmentation fine-tune losses — the JAX package's `train/losses.py`.

The reference configures its SAM2 fine-tune with weighted dice + focal +
IoU + frequency losses (weight_dice=0.5, weight_focal=0.4, weight_iou=0.3,
weight_freq=0.1, focal_alpha=0.25 — src/circuit_analyzer.py:218-222,
src/sam2_infer.py:297-301). `combined_loss` computes in float32 whatever
the model's dtype, as the JAX package casts (losses.py:71-72); the
frequency term is the L1 distance of |rfft2| magnitudes.
"""
from __future__ import annotations

import torch

from ..core.config import TrainConfig


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, smooth: float = 1e-5) -> torch.Tensor:
    """Soft dice over the full batch. logits/targets: (B, H, W)."""
    probs = torch.sigmoid(logits)
    inter = (probs * targets).sum(dim=(-1, -2))
    denom = probs.sum(dim=(-1, -2)) + targets.sum(dim=(-1, -2))
    dice = (2.0 * inter + smooth) / (denom + smooth)
    return (1.0 - dice).mean()


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
               gamma: float = 2.0) -> torch.Tensor:
    """Binary focal loss with logits (numerically stable)."""
    p = torch.sigmoid(logits)
    # maximum, not clamp: at a tie (a zero logit) both split the gradient,
    # as jnp.maximum does
    ce = (torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * targets + (1 - p) * (1 - targets)
    alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
    return (alpha_t * ((1 - p_t) ** gamma) * ce).mean()


def iou_prediction_loss(iou_pred: torch.Tensor, logits: torch.Tensor, targets: torch.Tensor,
                        threshold: float = 0.5, smooth: float = 1e-5) -> torch.Tensor:
    """MSE between the decoder's IoU head output and the actual IoU of the
    thresholded prediction (SAM-style IoU supervision); the threshold
    carries no gradient."""
    pred_mask = (torch.sigmoid(logits) > threshold).to(torch.float32)
    inter = (pred_mask * targets).sum(dim=(-1, -2))
    union = torch.maximum(pred_mask, targets).sum(dim=(-1, -2))
    actual_iou = (inter + smooth) / (union + smooth)
    return ((iou_pred.reshape(actual_iou.shape) - actual_iou) ** 2).mean()


def frequency_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """L1 over 2-D FFT magnitudes of predicted vs target masks."""
    f_pred = torch.fft.rfft2(torch.sigmoid(logits)).abs()
    f_true = torch.fft.rfft2(targets).abs()
    return (f_pred - f_true).abs().mean()


def combined_loss(logits: torch.Tensor, iou_pred: torch.Tensor, targets: torch.Tensor,
                  cfg: TrainConfig | None = None) -> tuple[torch.Tensor, dict]:
    """Weighted sum per the reference fine-tune configuration; returns
    (total, {"loss", "dice", "focal", "iou", "freq"})."""
    cfg = cfg or TrainConfig()
    logits = logits.to(torch.float32)
    targets = targets.to(torch.float32)
    l_dice = dice_loss(logits, targets, cfg.dice_smooth)
    l_focal = focal_loss(logits, targets, cfg.focal_alpha, cfg.focal_gamma)
    l_iou = iou_prediction_loss(iou_pred, logits, targets, smooth=cfg.iou_smooth)
    l_freq = frequency_loss(logits, targets)
    total = (cfg.weight_dice * l_dice + cfg.weight_focal * l_focal + cfg.weight_iou * l_iou
             + cfg.weight_freq * l_freq)
    return total, {"loss": total, "dice": l_dice, "focal": l_focal, "iou": l_iou,
                   "freq": l_freq}
