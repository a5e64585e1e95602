"""Prompt-free SAM 2.1 image segmenter in PyTorch — the whole device path.

Counterpart of the JAX package's `models/sam2/wrapper.py`:

  Hiera trunk → FPN neck (scalp=1) → conv_s0/s1 high-res projections →
  mask decoder with trainable dense (rank-r factored) and sparse prompt
  embeddings → bilinear upsample to the model resolution →
  MultiKernelRefinement (the `refinement` kernel).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.config import SAM2Config
from ...ops.cuda.refinement import KERNELS, refinement
from ...ops.image import resize_linear
from .decoder import MaskDecoder
from .hiera import Hiera, fused_gate
from .neck import FpnNeck, conv1x1_nhwc


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier dense positional encoding (SAM prompt encoder's
    get_dense_pe)."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(torch.zeros(2, num_pos_feats))

    def forward(self, h: int, w: int) -> torch.Tensor:
        gauss = self.positional_encoding_gaussian_matrix.float()
        dev = gauss.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)], dim=-1)
        coords = 2.0 * math.pi * ((2.0 * grid - 1.0) @ gauss)
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)  # (H, W, 2F)


class MultiKernelRefinement(nn.Module):
    """Parallel odd-kernel conv branches + GELU, 1×1 combiner, over
    (B, H, W, 1) logits — computed by the `refinement` kernel, or, where
    the kernel gate says so (hiera.force_fused: a non-trunk site, on the
    module path under any cutoff), by the convolutions themselves in the
    parameters' dtype, as the JAX module path computes them."""

    def __init__(self, kernel_sizes=KERNELS, intermediate_channels: int = 4):
        super().__init__()
        if tuple(kernel_sizes) != KERNELS or intermediate_channels != 4:
            raise ValueError(f"the refinement head is {KERNELS} × 4 channels, got "
                             f"{tuple(kernel_sizes)} × {intermediate_channels}")
        for i, k in enumerate(KERNELS):
            self.add_module(f"conv_branches_{i}", nn.Conv2d(1, 4, k, padding=k // 2))
        self.combiner_conv = nn.Conv2d(16, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [getattr(self, f"conv_branches_{i}") for i in range(len(KERNELS))]
        if not fused_gate(None):
            xc = x.permute(0, 3, 1, 2)
            cat = torch.cat([F.gelu(b(xc)) for b in branches], dim=1)
            return self.combiner_conv(cat).permute(0, 2, 3, 1)
        return refinement(
            x.contiguous(), [b.weight for b in branches], [b.bias for b in branches],
            self.combiner_conv.weight, self.combiner_conv.bias,
        )


class SAM2ImageSegmenter(nn.Module):
    """End-to-end prompt-free segmenter. Input: normalized (B, S, S, 3).

    Returns (high_res_logits (B, S, S, 1) float32, low_res_logits
    (B, S/4, S/4, 1) float32, iou_predictions (B, 1) float32).
    """

    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        self.trunk = Hiera(cfg.embed_dim, cfg.num_heads, cfg.stages, cfg.global_att_blocks,
                           cfg.window_pos_embed_bkg_spatial_size, cfg.window_spec)
        self.neck = FpnNeck(cfg.d_model, cfg.backbone_channel_list, cfg.fpn_top_down_levels)
        self.conv_s0 = nn.Conv2d(cfg.d_model, cfg.d_model // 8, 1)
        self.conv_s1 = nn.Conv2d(cfg.d_model, cfg.d_model // 4, 1)
        self.dense_pe = PositionEmbeddingRandom(cfg.d_model // 2)
        grid = cfg.resolution // 16
        r = cfg.trainable_embedding_r
        self.dense_embedding1 = nn.Parameter(torch.zeros(1, cfg.d_model, r))
        self.dense_embedding2 = nn.Parameter(torch.zeros(1, r, grid * grid))
        self.sparse_embedding = nn.Parameter(
            torch.zeros(1, cfg.sparse_embedding_len, cfg.d_model))
        self.sam_mask_decoder = MaskDecoder(
            cfg.d_model, cfg.decoder_mlp_dim, cfg.num_multimask_outputs,
            cfg.iou_head_depth, cfg.iou_head_hidden_dim, cfg.pred_obj_scores,
            cfg.pred_obj_scores_mlp, cfg.use_high_res_features,
            cfg.dynamic_multimask_via_stability, cfg.dynamic_multimask_stability_delta,
            cfg.dynamic_multimask_stability_thresh,
        )
        if cfg.use_refinement:
            self.refinement_layer = MultiKernelRefinement(
                cfg.refinement_kernels, cfg.refinement_channels)

    def forward(self, images: torch.Tensor):
        cfg = self.cfg
        dt = self.conv_s0.weight.dtype
        fpn = self.neck(self.trunk(images))
        fpn = fpn[: len(fpn) - cfg.scalp] if cfg.scalp else fpn
        feat_s0 = conv1x1_nhwc(self.conv_s0, fpn[0])
        feat_s1 = conv1x1_nhwc(self.conv_s1, fpn[1])
        image_embed = fpn[2]
        grid = image_embed.shape[1]
        image_pe = self.dense_pe(grid, grid)[None].to(dt)
        dense = torch.matmul(self.dense_embedding1, self.dense_embedding2)
        dense = dense.reshape(1, cfg.d_model, grid, grid).permute(0, 2, 3, 1)
        low_res, iou_pred = self.sam_mask_decoder(
            image_embed, image_pe, self.sparse_embedding.to(dt), dense.to(dt),
            (feat_s0, feat_s1),
        )
        low_res_nhwc = low_res.permute(0, 2, 3, 1)
        b = low_res_nhwc.shape[0]
        high_res = resize_linear(low_res_nhwc, (b, cfg.resolution, cfg.resolution, 1))
        if cfg.use_refinement:
            high_res = self.refinement_layer(high_res.to(dt)).to(dt).float()
        return high_res, low_res_nhwc, iou_pred
