"""Core image ops on tensors: colour conversion, resize, letterbox,
thresholding.

Counterparts of the JAX package's `ops/image.py`, which replace the
reference's cv2 calls:
  - cv2.cvtColor RGB→GRAY            (src/circuit_analyzer.py:316)
  - cv2.resize (INTER_LINEAR)        (src/circuit_analyzer.py:806)
  - cv2.adaptiveThreshold MEAN_C/INV (src/circuit_analyzer.py:318)
  - SAM2Transforms resize+normalize  (src/sam2_infer.py:41-51)
  - YOLO letterbox preprocessing     (ultralytics internal)

`resize_linear` is `jax.image.resize(..., "linear")` written out: the
same per-axis triangle-kernel weight matrices (scaled by the inverse
scale when antialiasing a downscale), contracted one dim at a time. Both the
upscale and the downscale therefore agree with the JAX package, where
`F.interpolate` would not (it never antialiases a bilinear downscale the
way JAX does, and its edge handling differs). All functions take and
return tensors on the caller's device, in float32, but
`resize_linear_u8`, cv2.resize INTER_LINEAR on a uint8 host array in
cv2's own fixed point, for the images that must be byte-equal to cv2's
(the crop reader's direction crops, the node-visualisation base).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# ImageNet statistics used by SAM2Transforms (src/sam2_infer.py:41-42).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma, matching cv2.cvtColor(..., COLOR_RGB2GRAY)."""
    img = img.to(torch.float32)
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def _weight_mat(in_size: int, out_size: int, antialias: bool, device) -> torch.Tensor:
    """(in, out) float32 linear-resize weights, jax.image's
    compute_weight_mat with a triangle kernel and zero translation."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    f32 = torch.float32
    sample_f = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (
        torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None])
        / kernel_scale
    )
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(
        torch.abs(total) > eps, w / torch.where(total != 0, total, torch.ones_like(total)), 0.0
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_linear(
    x: torch.Tensor, shape: tuple[int, ...], antialias: bool = True
) -> torch.Tensor:
    """`jax.image.resize(x, shape, "linear", antialias)`: every dim whose
    size changes is contracted with its weight matrix, in dim order."""
    x = x.to(torch.float32)
    for d, n in enumerate(shape):
        m = x.shape[d]
        if m != n:
            wm = _weight_mat(m, n, antialias, x.device)
            x = torch.movedim(torch.tensordot(x, wm, dims=([d], [0])), -1, d)
    return x


def resize_bilinear(
    img: torch.Tensor, out_hw: tuple[int, int], antialias: bool = True
) -> torch.Tensor:
    """Bilinear resize of an (H, W[, C]) tensor with half-pixel centres.

    antialias matters only when DOWNSCALING:
      * False → plain 2-tap bilinear == cv2.resize INTER_LINEAR and torch
        F.interpolate's default;
      * True → triangle-filtered == torchvision Resize's tensor default
        (SAM2 preprocessing).
    """
    return resize_linear(img, tuple(out_hw) + tuple(img.shape[2:]), antialias)


def adaptive_threshold_mean_inv(
    gray: torch.Tensor, block_size: int = 31, c: float = 21.0
) -> torch.Tensor:
    """cv2.adaptiveThreshold(ADAPTIVE_THRESH_MEAN_C, THRESH_BINARY_INV):
    255 where src <= mean(block) - C else 0, with an edge-replicated
    block (reference `segment_circuit`, src/circuit_analyzer.py:313-319).
    The block sum is taken in float64, so its rounding never depends on
    the summation order."""
    pad = block_size // 2
    g = gray.to(torch.float32)
    x = F.pad(g[None, None].to(torch.float64), (pad, pad, pad, pad), mode="replicate")
    summed = F.avg_pool2d(x, block_size, stride=1, divisor_override=1)[0, 0]
    mean = summed.to(torch.float32) / float(block_size * block_size)
    return torch.where(g <= mean - c, 255.0, 0.0).to(torch.uint8)


def normalize_imagenet(img01: torch.Tensor) -> torch.Tensor:
    """Channel-wise ImageNet normalization of a [0,1] RGB image (..., 3)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img01.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img01.device)
    return (img01.to(torch.float32) - mean) / std


def sam2_preprocess(img_rgb_u8: torch.Tensor, resolution: int = 1024) -> torch.Tensor:
    """uint8 RGB (H, W, 3) → normalized (resolution, resolution, 3) float32
    (SAM2Transforms: ToTensor → Resize(res², bilinear) → Normalize)."""
    img01 = img_rgb_u8.to(torch.float32) / 255.0
    resized = resize_bilinear(img01, (resolution, resolution))
    return normalize_imagenet(resized)


def letterbox(
    img_rgb_u8: torch.Tensor, out_size: int = 640, pad_value: float = 114.0
) -> tuple[torch.Tensor, float, tuple[float, float]]:
    """Aspect-preserving resize + centred pad (YOLO letterbox).

    Returns (letterboxed float32 (out, out, 3), scale, (pad_x, pad_y)).
    """
    h, w = img_rgb_u8.shape[:2]
    scale = min(out_size / h, out_size / w)
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    # ultralytics letterboxes with cv2.resize INTER_LINEAR → no antialias
    resized = resize_bilinear(img_rgb_u8.to(torch.float32), (new_h, new_w), antialias=False)
    pad_y, pad_x = (out_size - new_h) // 2, (out_size - new_w) // 2
    canvas = torch.full(
        (out_size, out_size, 3), pad_value, dtype=torch.float32, device=img_rgb_u8.device
    )
    canvas[pad_y : pad_y + new_h, pad_x : pad_x + new_w] = resized
    return canvas, scale, (float(pad_x), float(pad_y))


def crop_sam2_preprocess(img_u8: torch.Tensor, y0: int, x0: int, crop_h: int, crop_w: int,
                         resolution: int) -> torch.Tensor:
    """The (crop_h, crop_w) window at (y0, x0) sliced out of an uploaded
    uint8 image, then `sam2_preprocess` (JAX pipeline/batch.py:80-103):
    the crop never travels from the host again."""
    return sam2_preprocess(img_u8[y0:y0 + crop_h, x0:x0 + crop_w], resolution)


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """Source indices and 11-bit weights of OpenCV's INTER_LINEAR along one
    axis (imgproc/resize.cpp): fx = (float)((d + 0.5)·src/dst − 0.5),
    index floor(fx), weights round((1 − f)·2048) and round(f·2048). Along
    x a tap outside the image pins the weight (0 → 2048, 0); along y only
    the row indices are clamped and the weights stay."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        edge = (s < 0) | (s >= src - 1)
        f[edge] = 0.0
        s = np.clip(s, 0, src - 1)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """uint8 (H, W[, C]) → (out_h, out_w[, C]) on the host, byte-equal to
    cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR).
    OpenCV resizes in fixed point: the horizontal pass sums pixel × 11-bit
    weight exactly in int32; the vertical pass (its SIMD form) narrows
    each row sum to int16 by >> 4, multiplies by its 11-bit weight keeping
    the high 16 bits, adds the two, and rounds off 2 more bits."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    out_h, out_w = out_hw
    x0, x1, a0, a1 = _linear_taps(w, out_w, clamp_weights=True)
    y0, y1, b0, b1 = _linear_taps(h, out_h, clamp_weights=False)
    # int32 holds every sum: 255 · 2048 horizontally, 32767 · 2048 vertically
    src = img.reshape(h, w, -1)
    a0, a1 = a0.astype(np.int32)[None, :, None], a1.astype(np.int32)[None, :, None]
    rows = (src[:, x0].astype(np.int32) * a0 + src[:, x1].astype(np.int32) * a1) >> 4
    np.clip(rows, -32768, 32767, out=rows)
    b0, b1 = b0.astype(np.int32)[:, None, None], b1.astype(np.int32)[:, None, None]
    out = (((rows[y0] * b0) >> 16) + ((rows[y1] * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape((out_h, out_w) + img.shape[2:])
