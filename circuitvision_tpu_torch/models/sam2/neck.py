"""FPN neck of the SAM 2.1 image encoder, in PyTorch, NHWC.

Counterpart of the JAX package's `models/sam2/neck.py`: lateral 1×1
convs over the trunk outputs, nearest-neighbour top-down fusion only at
the levels in `fpn_top_down_levels`. The sine position encodings the JAX
neck also returns are never consumed by the image path and the neck does
not compute them; `position_embedding_sine` gives them on request.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 256,
                            temperature: float = 10000.0, device=None) -> torch.Tensor:
    """(H, W, num_pos_feats) float32 sine embedding (sam2
    PositionEmbeddingSine, normalize=True, scale=2π; JAX neck.py:18)."""
    half = num_pos_feats // 2
    scale = 2.0 * math.pi
    eps = 1e-6
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_t = torch.arange(half, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / half)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()], dim=-1).reshape(h, w, half)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()], dim=-1).reshape(h, w, half)
    return torch.cat([pos_y, pos_x], dim=-1)


def conv1x1_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW Conv2d to an NHWC tensor, returning NHWC."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class FpnNeck(nn.Module):
    """Takes trunk outputs high-res-first; returns features high-res-first."""

    def __init__(self, d_model=256, backbone_channel_list=(1152, 576, 288, 144),
                 fpn_top_down_levels=(2, 3)):
        super().__init__()
        self.n = len(backbone_channel_list) - 1
        self.fpn_top_down_levels = tuple(fpn_top_down_levels)
        for k, c in enumerate(backbone_channel_list):  # low-res first
            self.add_module(f"convs_{k}_conv", nn.Conv2d(c, d_model, 1))

    def forward(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        n = self.n
        out: list = [None] * len(xs)
        prev = None
        for i in range(n, -1, -1):  # low-res → high-res
            conv = getattr(self, f"convs_{n - i}_conv")
            lateral = conv1x1_nhwc(conv, xs[i].to(conv.weight.dtype))
            if i in self.fpn_top_down_levels and prev is not None:
                top_down = F.interpolate(prev.float().permute(0, 3, 1, 2), scale_factor=2,
                                         mode="nearest").permute(0, 2, 3, 1)
                prev = lateral + top_down.to(lateral.dtype)
            else:
                prev = lateral
            out[i] = prev
        return out
