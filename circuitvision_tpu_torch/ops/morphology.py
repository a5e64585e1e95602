"""Grayscale morphology and blur on tensors.

Counterpart of the JAX package's `ops/morphology.py`, the reference's
line-enhancement stack (src/circuit_analyzer.py:289-311): Gaussian blur
(5×5, σ=1) → dilate ×2 → erode ×2 with a 3×3 ones kernel, each stage
with cv2's replicate border at the image edge.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _replicate_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(img[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]


def dilate(img: torch.Tensor, ksize: int = 3, iterations: int = 1) -> torch.Tensor:
    """Grayscale dilation with a ksize×ksize ones kernel (cv2.dilate)."""
    out = img.to(torch.float32)
    for _ in range(iterations):
        out = F.max_pool2d(_replicate_pad(out, ksize // 2)[None, None], ksize, 1)[0, 0]
    return out


def erode(img: torch.Tensor, ksize: int = 3, iterations: int = 1) -> torch.Tensor:
    """Grayscale erosion with a ksize×ksize ones kernel (cv2.erode)."""
    out = img.to(torch.float32)
    for _ in range(iterations):
        out = -F.max_pool2d(-_replicate_pad(out, ksize // 2)[None, None], ksize, 1)[0, 0]
    return out


def gaussian_kernel_1d(ksize: int, sigma: float) -> list[float]:
    """cv2.getGaussianKernel taps (sigma ≤ 0 derives from k), evaluated
    in float32 with the JAX package's expression order so the taps are
    the same float32 values."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = torch.arange(ksize, dtype=torch.float32) - (ksize - 1) / 2.0
    k = torch.exp(-(xs**2) / (2.0 * sigma * sigma))
    return (k / k.sum()).tolist()


def gaussian_blur(img: torch.Tensor, ksize: int = 5, sigma: float = 1.0) -> torch.Tensor:
    """Separable Gaussian blur with replicate borders (cv2.GaussianBlur):
    horizontal taps summed in order, then vertical."""
    k = gaussian_kernel_1d(ksize, sigma)
    h, w = img.shape
    x = _replicate_pad(img.to(torch.float32), ksize // 2)
    hz = sum(k[i] * x[:, i : i + w] for i in range(ksize))
    return sum(k[i] * hz[i : i + h, :] for i in range(ksize))


def enhance_lines(mask: torch.Tensor, blur_ksize: int = 5, blur_sigma: float = 1.0,
                  morph_ksize: int = 3, iterations: int = 2) -> torch.Tensor:
    """Blur → dilate×N → erode×N (reference enhance_lines,
    src/circuit_analyzer.py:289-311). Input/output are 0..255 grayscale."""
    blurred = gaussian_blur(mask, blur_ksize, blur_sigma)
    return erode(dilate(blurred, morph_ksize, iterations), morph_ksize, iterations)


def boundary_mask(fg: torch.Tensor) -> torch.Tensor:
    """Foreground pixels with at least one 8-neighbour background pixel
    (the image edge counts as background, as in cv2.findContours)."""
    f = fg.to(torch.float32)
    padded = F.pad(f[None, None], (1, 1, 1, 1), value=0.0)
    interior = -F.max_pool2d(-padded, 3, 1)[0, 0]
    return (f > 0) & (interior == 0)
