"""FPN neck of the SAM 2.1 image encoder, in PyTorch, NHWC.

Counterpart of the JAX package's `models/sam2/neck.py`: lateral 1×1
convs over the trunk outputs, nearest-neighbour top-down fusion only at
the levels in `fpn_top_down_levels`. The sine position encodings the JAX
neck also returns are never consumed by the image path and are not
computed here.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


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
