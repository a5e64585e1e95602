"""Degradation tiers for the eval set: the JAX package's `eval/degrade.py`,
byte for byte, with its PIL JPEG round trip done by `io/image_io`.

The reference demonstrably ingests photos and hand drawings
(the reference's README: the SAM2 fine-tune set is 267 real
circuit images), while this repo's eval circuits are clean synthetic
renders — so the robustness half of the capability surface had no
measurement. Each tier here is a deterministic corruption of an eval
image approximating one real-world failure axis:

  blur         — defocus/camera shake (separable Gaussian, sigma 2.2)
  shadow       — uneven illumination: corner-anchored multiplicative
                 gradient down to 45% brightness + global dim
  jpeg         — heavy compression artifacts (real JPEG round-trip, q=12:
                 io/image_io.encode_jpeg writes PIL's bytes, the port's
                 decoder reads them as PIL does)
  perspective  — off-axis photo: projective warp with corner
                 displacements up to 6% of the image size (GEOMETRIC:
                 boxes/masks must be warped with the same transform)
  wobble       — hand-drawn stroke jitter: smooth random elastic
                 displacement field, ~2.5 px amplitude (geometric but
                 locally small; boxes keep their AABBs, masks warp)

Everything is numpy-only (no cv2 — the repo replaces it; no scipy).
Geometric tiers return a `Warp` the caller applies to GT boxes and
masks so oracle-box / mask-IoU scoring stays consistent with the
corrupted image.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Optional

import numpy as np


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _gaussian_kernel1d(sigma: float) -> np.ndarray:
    r = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _blur2d(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur over the leading two axes (edge-padded)."""
    k = _gaussian_kernel1d(sigma)
    r = len(k) // 2
    out = img.astype(np.float64)
    p = np.pad(out, ((r, r), (0, 0)) + ((0, 0),) * (out.ndim - 2), mode="edge")
    out = sum(k[i] * p[i : i + out.shape[0]] for i in range(len(k)))
    p = np.pad(out, ((0, 0), (r, r)) + ((0, 0),) * (out.ndim - 2), mode="edge")
    out = sum(k[i] * p[:, i : i + out.shape[1]] for i in range(len(k)))
    return out


def _bilinear_sample(img: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                     fill: float) -> np.ndarray:
    """Sample img (H, W[, C]) at float coords; outside → fill."""
    h, w = img.shape[:2]
    valid = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    ys_c = np.clip(ys, 0, h - 1)
    xs_c = np.clip(xs, 0, w - 1)
    y0 = np.floor(ys_c).astype(np.int64)
    x0 = np.floor(xs_c).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys_c - y0)[..., None] if img.ndim == 3 else ys_c - y0
    wx = (xs_c - x0)[..., None] if img.ndim == 3 else xs_c - x0
    f = img.astype(np.float64)
    top = f[y0, x0] * (1 - wx) + f[y0, x1] * wx
    bot = f[y1, x0] * (1 - wx) + f[y1, x1] * wx
    out = top * (1 - wy) + bot * wy
    if img.ndim == 3:
        out[~valid] = fill
    else:
        out = np.where(valid, out, fill)
    return out


# ---------------------------------------------------------------------------
# warps (geometric tiers)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Warp:
    """Forward point map (x, y) → (x', y') plus the inverse sampling
    fields used to resample rasters. Boxes map via their 4 corners'
    AABB; masks resample with the same inverse fields as the image."""

    fwd: Callable  # (xs, ys) arrays → (xs', ys')
    inv_ys: np.ndarray  # (H, W) source y for each output pixel
    inv_xs: np.ndarray

    def apply_to_boxes(self, boxes):
        import dataclasses as _dc

        out = []
        for b in boxes:
            cx = np.asarray([b.xmin, b.xmax, b.xmin, b.xmax], np.float64)
            cy = np.asarray([b.ymin, b.ymin, b.ymax, b.ymax], np.float64)
            nx, ny = self.fwd(cx, cy)
            out.append(
                _dc.replace(
                    b,
                    xmin=int(round(nx.min())), ymin=int(round(ny.min())),
                    xmax=int(round(nx.max())), ymax=int(round(ny.max())),
                    persistent_uid="",
                )
            )
        return out

    def apply_to_mask(self, mask: np.ndarray) -> np.ndarray:
        out = _bilinear_sample(mask, self.inv_ys, self.inv_xs, fill=0.0)
        return (out > 127.0).astype(np.uint8) * 255


def _perspective_warp(h: int, w: int, rng: np.random.Generator,
                      max_frac: float = 0.06) -> Warp:
    """Projective transform mapping the image corners to jittered
    positions (each displaced up to max_frac of the diagonal axis)."""
    src = np.asarray(
        [[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], np.float64
    )
    dx = rng.uniform(-max_frac * w, max_frac * w, 4)
    dy = rng.uniform(-max_frac * h, max_frac * h, 4)
    dst = src + np.stack([dx, dy], axis=1)

    def solve_homography(p_src, p_dst):
        a = []
        for (x, y), (u, v) in zip(p_src, p_dst):
            a.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
            a.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
        _, _, vt = np.linalg.svd(np.asarray(a))
        return vt[-1].reshape(3, 3)

    hm = solve_homography(src, dst)  # forward: src → dst
    hm_inv = np.linalg.inv(hm)

    def fwd(xs, ys):
        d = hm[2, 0] * xs + hm[2, 1] * ys + hm[2, 2]
        return (
            (hm[0, 0] * xs + hm[0, 1] * ys + hm[0, 2]) / d,
            (hm[1, 0] * xs + hm[1, 1] * ys + hm[1, 2]) / d,
        )

    gy, gx = np.mgrid[0:h, 0:w].astype(np.float64)
    d = hm_inv[2, 0] * gx + hm_inv[2, 1] * gy + hm_inv[2, 2]
    inv_xs = (hm_inv[0, 0] * gx + hm_inv[0, 1] * gy + hm_inv[0, 2]) / d
    inv_ys = (hm_inv[1, 0] * gx + hm_inv[1, 1] * gy + hm_inv[1, 2]) / d
    return Warp(fwd=fwd, inv_ys=inv_ys, inv_xs=inv_xs)


def _wobble_warp(h: int, w: int, rng: np.random.Generator,
                 amp: float = 2.5, smooth: float = 24.0) -> Warp:
    """Smooth elastic displacement ≈ hand-drawn stroke wobble."""
    dx = _blur2d(rng.standard_normal((h, w)), smooth)
    dy = _blur2d(rng.standard_normal((h, w)), smooth)
    dx *= amp / (np.abs(dx).max() + 1e-9)
    dy *= amp / (np.abs(dy).max() + 1e-9)
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float64)
    # inverse sampling field: output pixel reads from (x - dx, y - dy)
    inv_xs, inv_ys = gx - dx, gy - dy

    def fwd(xs, ys):
        row = np.clip(np.round(ys).astype(np.int64), 0, h - 1)
        col = np.clip(np.round(xs).astype(np.int64), 0, w - 1)
        return xs + dx[row, col], ys + dy[row, col]

    return Warp(fwd=fwd, inv_ys=inv_ys, inv_xs=inv_xs)


# ---------------------------------------------------------------------------
# tiers
# ---------------------------------------------------------------------------

def _tier_blur(img, rng):
    return np.clip(_blur2d(img, 2.2), 0, 255).astype(np.uint8), None


def _tier_shadow(img, rng):
    h, w = img.shape[:2]
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float64)
    corner = rng.integers(0, 4)
    u = gx / max(w - 1, 1)
    v = gy / max(h - 1, 1)
    if corner in (1, 3):
        u = 1.0 - u
    if corner in (2, 3):
        v = 1.0 - v
    ramp = 0.45 + 0.55 * np.clip(u * 0.7 + v * 0.7, 0, 1)  # dark corner
    out = img.astype(np.float64) * ramp[..., None] * 0.92
    return np.clip(out, 0, 255).astype(np.uint8), None


def _tier_jpeg(img, rng):
    from ..io.image_io import decode_image, encode_jpeg

    return decode_image(encode_jpeg(np.ascontiguousarray(img, np.uint8), quality=12)), None


def _tier_perspective(img, rng):
    h, w = img.shape[:2]
    warp = _perspective_warp(h, w, rng)
    out = _bilinear_sample(img, warp.inv_ys, warp.inv_xs, fill=255.0)
    return np.clip(out, 0, 255).astype(np.uint8), warp


def _tier_wobble(img, rng):
    h, w = img.shape[:2]
    warp = _wobble_warp(h, w, rng)
    out = _bilinear_sample(img, warp.inv_ys, warp.inv_xs, fill=255.0)
    return np.clip(out, 0, 255).astype(np.uint8), warp


DEGRADE_TIERS = {
    "blur": _tier_blur,
    "shadow": _tier_shadow,
    "jpeg": _tier_jpeg,
    "perspective": _tier_perspective,
    "wobble": _tier_wobble,
}


def degrade(
    image: np.ndarray,
    tier: str,
    seed: int,
    boxes=None,
    mask: Optional[np.ndarray] = None,
):
    """Apply one tier. Returns (image', boxes', mask') with GT warped
    consistently for geometric tiers (unchanged references otherwise).
    Deterministic in (tier, seed, image shape)."""
    if tier not in DEGRADE_TIERS:
        raise KeyError(f"unknown degradation tier {tier!r}; "
                       f"have {sorted(DEGRADE_TIERS)}")
    # zlib.crc32 is process-stable (built-in hash() is salted per process
    # via PYTHONHASHSEED, which silently broke cross-run determinism).
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(tier.encode()) & 0x7FFFFFFF])
    )
    out, warp = DEGRADE_TIERS[tier](np.asarray(image), rng)
    new_boxes, new_mask = boxes, mask
    if warp is not None:
        if boxes is not None:
            new_boxes = warp.apply_to_boxes(boxes)
        if mask is not None:
            new_mask = warp.apply_to_mask(np.asarray(mask))
    return out, new_boxes, new_mask
