"""Shared building blocks of the detector and the segmenter, in PyTorch.

Counterparts of the JAX package's `models/layers.py` (the YOLOv11
component family — Conv-BN-SiLU, C3k2, SPPF, C2PSA — and SAM's MLP).
The convolution blocks run NCHW, PyTorch's habit; the models convert at
their public boundary, which keeps the JAX package's NHWC. Submodules
carry the JAX parameter tree's names (`cv1`, `m_0`, `bn`, ...) so that
`models/bridge.py` maps one tree onto the other by name.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def autopad(k: int, p: int | None = None, d: int = 1) -> int:
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2 if p is None else p


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm computed as flax does, in the dtype of its
    parameters and statistics: (x − mean)·(rsqrt(var + eps)·scale) + bias
    over NCHW channels. The square root is taken in float32 and rounded,
    as XLA computes a bfloat16 rsqrt (PyTorch's bfloat16 rsqrt on the CPU
    may differ from it by one ulp). The per-channel factor
    rsqrt(var + eps)·scale is computed once for each version of the
    variance and scale tensors, except under autograd when either requires
    grad: the detector's trainer differentiates the statistics as well
    (the JAX trainer differentiates and updates the whole variable tree,
    `batch_stats` included), so the factor is then part of the graph."""

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self._factor = (None, None)

    def factor(self) -> torch.Tensor:
        if torch.is_grad_enabled() and (self.running_var.requires_grad
                                        or self.weight.requires_grad):
            var = self.running_var + self.eps
            return (torch.rsqrt(var.float()).to(var.dtype) * self.weight)[:, None, None]
        key = tuple((t.data_ptr(), t._version, t.dtype) for t in (self.running_var, self.weight))
        if self._factor[0] != key:
            with torch.no_grad():
                var = self.running_var + self.eps
                mul = torch.rsqrt(var.float()).to(var.dtype) * self.weight
            self._factor = (key, mul[:, None, None])
        return self._factor[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.running_mean[:, None, None]) * self.factor() + self.bias[:, None, None]


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the last axis: float32 statistics in the
    fast-variance form (mean of x² less the squared mean, clamped at 0),
    (x − mean)·(rsqrt(var + eps)·scale) + bias in float32, rounded once to
    the input dtype. Scale and bias in float32 storage (`place`)."""

    float32_params = True

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


def place(model: nn.Module, device, dtype: torch.dtype) -> nn.Module:
    """Move `model` to `device` with every float parameter and buffer in
    the compute dtype `dtype`, as the JAX analyzer casts its variables
    (`cast_float_params`, pipeline/analyzer.py:104, :124). LayerNorm
    scales and biases (modules marked `float32_params`) keep those rounded
    values in float32 storage: flax promotes them to float32 for its
    float32 statistics anyway, and the kernels read them as float32."""
    model.to(device=device, dtype=dtype)
    for m in model.modules():
        if getattr(m, "float32_params", False):
            m.float()
    return model


def silu(x: torch.Tensor) -> torch.Tensor:
    """flax's `nn.silu`, x·sigmoid(x), as XLA computes it: in a 16-bit
    dtype every step of sigmoid's expansion 1 / (1 + exp(−x)) rounds to
    that dtype, and then the product does (PyTorch's one-pass silu rounds
    once and differs in about a third of the values). In float32
    PyTorch's silu."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


class ConvBN(nn.Module):
    """Conv2d + BatchNorm + SiLU (ultralytics `Conv`); `groups=-1` makes
    it depthwise (DWConvBN)."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 1, stride: int = 1,
                 groups: int = 1, act: bool = True):
        super().__init__()
        groups = c_in if groups == -1 else groups
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride, autopad(kernel), groups=groups,
                              bias=False)
        self.bn = FrozenBatchNorm(c_out)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return silu(x) if self.act else x


def DWConvBN(c_in: int, c_out: int, kernel: int = 1, act: bool = True) -> ConvBN:
    return ConvBN(c_in, c_out, kernel, groups=-1, act=act)


class Bottleneck(nn.Module):
    """Standard YOLO bottleneck: two convs with optional residual."""

    def __init__(self, c_in: int, features: int, shortcut: bool = True,
                 kernels=(3, 3), expansion: float = 0.5):
        super().__init__()
        hidden = int(features * expansion)
        self.cv1 = ConvBN(c_in, hidden, kernels[0])
        self.cv2 = ConvBN(hidden, features, kernels[1])
        self.add = shortcut and c_in == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    """CSP block with 3 convs and n inner bottlenecks (ultralytics C3k)."""

    def __init__(self, c_in: int, features: int, n: int = 2, shortcut: bool = True,
                 expansion: float = 0.5, kernel: int = 3):
        super().__init__()
        hidden = int(features * expansion)
        self.cv1 = ConvBN(c_in, hidden, 1)
        self.cv2 = ConvBN(c_in, hidden, 1)
        self.n = n
        for i in range(n):
            self.add_module(f"m_{i}", Bottleneck(hidden, hidden, shortcut, (kernel, kernel), 1.0))
        self.cv3 = ConvBN(2 * hidden, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv1(x)
        b = self.cv2(x)
        for i in range(self.n):
            a = getattr(self, f"m_{i}")(a)
        return self.cv3(torch.cat([a, b], dim=1))


class C3k2(nn.Module):
    """C2f-style split block whose inner units are C3k blocks (YOLOv11)."""

    def __init__(self, c_in: int, features: int, n: int = 2, c3k: bool = True,
                 expansion: float = 0.5, shortcut: bool = True):
        super().__init__()
        hidden = int(features * expansion)
        self.cv1 = ConvBN(c_in, 2 * hidden, 1)
        self.n = n
        for i in range(n):
            unit = (C3k(hidden, hidden, 2, shortcut) if c3k
                    else Bottleneck(hidden, hidden, shortcut, (3, 3), 0.5))
            self.add_module(f"m_{i}", unit)
        self.cv2 = ConvBN((2 + n) * hidden, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = list(self.cv1(x).chunk(2, dim=1))
        cur = outs[1]
        for i in range(self.n):
            cur = getattr(self, f"m_{i}")(cur)
            outs.append(cur)
        return self.cv2(torch.cat(outs, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5×5 max-pools."""

    def __init__(self, c_in: int, features: int, pool: int = 5):
        super().__init__()
        hidden = c_in // 2
        self.cv1 = ConvBN(c_in, hidden, 1)
        self.cv2 = ConvBN(4 * hidden, features, 1)
        self.pool = pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], self.pool, 1, self.pool // 2))
        return self.cv2(torch.cat(pools, dim=1))


class PSAAttention(nn.Module):
    """Position-sensitive attention used inside C2PSA: a fused qkv 1×1
    conv, attention over the flattened spatial dim, and a depthwise 3×3
    positional branch on V."""

    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        self.qkv = ConvBN(dim, dim + 2 * self.key_dim * num_heads, 1, act=False)
        self.pe = DWConvBN(dim, dim, 3, act=False)
        self.proj = ConvBN(dim, dim, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        kd, hd = self.key_dim, self.head_dim
        qkv = self.qkv(x).permute(0, 2, 3, 1).reshape(b, h * w, self.num_heads, 2 * kd + hd)
        q, k, v = qkv.split([kd, kd, hd], dim=-1)
        attn = torch.einsum("bnhk,bmhk->bhnm", q.float(), k.float())
        attn = torch.softmax(attn * self.scale, dim=-1).to(v.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
        out = out.reshape(b, h, w, c).permute(0, 3, 1, 2)
        pe = self.pe(v.reshape(b, h, w, c).permute(0, 3, 1, 2))
        return self.proj(out + pe)


class PSABlock(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.attn = PSAAttention(dim, num_heads)
        self.ffn_0 = ConvBN(dim, dim * 2, 1)
        self.ffn_1 = ConvBN(dim * 2, dim, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        return x + self.ffn_1(self.ffn_0(x))


class C2PSA(nn.Module):
    """Cross-stage partial block with PSA attention units (YOLOv11)."""

    def __init__(self, c_in: int, features: int, n: int = 2, expansion: float = 0.5):
        super().__init__()
        hidden = int(features * expansion)
        self.cv1 = ConvBN(c_in, 2 * hidden, 1)
        self.n = n
        for i in range(n):
            self.add_module(f"m_{i}", PSABlock(hidden, max(1, hidden // 64)))
        self.cv2 = ConvBN(2 * hidden, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).chunk(2, dim=1)
        for i in range(self.n):
            b = getattr(self, f"m_{i}")(b)
        return self.cv2(torch.cat([a, b], dim=1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsample of NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class MLP(nn.Module):
    """SAM-style MLP head with ReLU between `num_layers` Linear layers."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 sigmoid_output: bool = False):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"layers_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return torch.sigmoid(x) if self.sigmoid_output else x
