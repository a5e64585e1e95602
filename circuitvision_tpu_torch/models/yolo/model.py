"""YOLOv11 detector in PyTorch.

Counterpart of the JAX package's `models/yolo/model.py`: Conv stem →
C3k2 stages → SPPF → C2PSA backbone, PAN head fusing P3/P4/P5, and a
decoupled detect head with DFL box regression, at the ultralytics
yolo11{n,s,m,l,x} compound-scaling presets. Input and outputs keep the
JAX package's NHWC layout; the convolutions run NCHW inside.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import C2PSA, C3k2, ConvBN, DWConvBN, SPPF, upsample2x

# depth multiple, width multiple, max channels (ultralytics yolo11 scales)
SCALES: dict[str, tuple[float, float, int]] = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}


def _make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


@dataclasses.dataclass(frozen=True)
class YOLOArch:
    """Resolved channel/repeat plan for one scale."""

    channels: tuple[int, ...]  # c for layers 0..10 (backbone outputs)
    head_channels: tuple[int, int, int]  # P3, P4, P5 feature widths
    repeats: int  # C3k2 repeat count after depth scaling
    c3k: bool  # whether C3k2 units are C3k blocks

    @classmethod
    def for_scale(cls, scale: str) -> "YOLOArch":
        depth, width, max_ch = SCALES[scale]

        def ch(x: int) -> int:
            return _make_divisible(min(x, max_ch) * width)

        n = max(round(2 * depth), 1)
        channels = (
            ch(64), ch(128), ch(256), ch(256), ch(512), ch(512), ch(512),
            ch(1024), ch(1024), ch(1024), ch(1024),
        )
        head = (ch(256), ch(512), ch(1024))
        return cls(channels=channels, head_channels=head, repeats=n,
                   c3k=scale in ("m", "l", "x"))


def _conv_then_bias(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A head's 1×1 convolution as flax's `nn.Conv` computes it: the
    product rounds to the compute dtype, then the bias is added (PyTorch's
    convolution adds the bias before it rounds)."""
    return F.conv2d(x, conv.weight) + conv.bias[:, None, None]


class YOLOv11(nn.Module):
    """Full detector. Input (B, H, W, 3) normalized to [0, 1]; returns 3
    per-scale float32 tensors (B, Hs, Ws, 4*reg_max + nc) for strides
    (8, 16, 32)."""

    def __init__(self, num_classes: int = 62, scale: str = "l", reg_max: int = 16):
        super().__init__()
        arch = YOLOArch.for_scale(scale)
        ch, n, c3k = arch.channels, arch.repeats, arch.c3k
        self.reg_max = reg_max
        self.num_classes = num_classes
        self.b0 = ConvBN(3, ch[0], 3, 2)
        self.b1 = ConvBN(ch[0], ch[1], 3, 2)
        self.b2 = C3k2(ch[1], ch[2], n, c3k, 0.25)
        self.b3 = ConvBN(ch[2], ch[3], 3, 2)
        self.b4 = C3k2(ch[3], ch[4], n, c3k, 0.25)
        self.b5 = ConvBN(ch[4], ch[5], 3, 2)
        # yolo11.yaml marks layers 6, 8 and 22 c3k=True at every scale
        self.b6 = C3k2(ch[5], ch[6], n, True, 0.5)
        self.b7 = ConvBN(ch[6], ch[7], 3, 2)
        self.b8 = C3k2(ch[7], ch[8], n, True, 0.5)
        self.b9 = SPPF(ch[8], ch[9], 5)
        self.b10 = C2PSA(ch[9], ch[10], n)
        hc3, hc4, hc5 = arch.head_channels
        self.h13 = C3k2(ch[10] + ch[6], hc4, n, c3k, 0.5)
        self.h16 = C3k2(hc4 + ch[4], hc3, n, c3k, 0.5)
        self.h17 = ConvBN(hc3, hc3, 3, 2)
        self.h19 = C3k2(hc3 + hc4, hc4, n, c3k, 0.5)
        self.h20 = ConvBN(hc4, hc4, 3, 2)
        self.h22 = C3k2(hc4 + ch[10], hc5, n, True, 0.5)
        c2 = max(16, hc3 // 4, reg_max * 4)
        c3 = max(hc3, min(num_classes, 100))
        for i, f in enumerate((hc3, hc4, hc5)):
            self.add_module(f"cv2_{i}_0", ConvBN(f, c2, 3))
            self.add_module(f"cv2_{i}_1", ConvBN(c2, c2, 3))
            self.add_module(f"cv2_{i}_2", nn.Conv2d(c2, 4 * reg_max, 1))
            self.add_module(f"cv3_{i}_0_0", DWConvBN(f, f, 3))
            self.add_module(f"cv3_{i}_0_1", ConvBN(f, c3, 1))
            self.add_module(f"cv3_{i}_1_0", DWConvBN(c3, c3, 3))
            self.add_module(f"cv3_{i}_1_1", ConvBN(c3, c3, 1))
            self.add_module(f"cv3_{i}_2", nn.Conv2d(c3, num_classes, 1))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        dt = self.b0.conv.weight.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = self.b3(self.b2(self.b1(self.b0(x))))
        p3 = self.b4(x)
        p4 = self.b6(self.b5(p3))
        p5 = self.b10(self.b9(self.b8(self.b7(p4))))
        h13 = self.h13(torch.cat([upsample2x(p5), p4], dim=1))
        h16 = self.h16(torch.cat([upsample2x(h13), p3], dim=1))
        h19 = self.h19(torch.cat([self.h17(h16), h13], dim=1))
        h22 = self.h22(torch.cat([self.h20(h19), p5], dim=1))
        outs = []
        for i, f in enumerate((h16, h19, h22)):
            m = lambda name: getattr(self, f"{name}")  # noqa: E731
            box = _conv_then_bias(m(f"cv2_{i}_2"), m(f"cv2_{i}_1")(m(f"cv2_{i}_0")(f)))
            cls = m(f"cv3_{i}_0_1")(m(f"cv3_{i}_0_0")(f))
            cls = _conv_then_bias(m(f"cv3_{i}_2"), m(f"cv3_{i}_1_1")(m(f"cv3_{i}_1_0")(cls)))
            outs.append(torch.cat([box, cls], dim=1).float().permute(0, 2, 3, 1))
        return outs
