"""A rasteriser for the debug drawings, pixel for pixel as cv2 5.0.0 draws.

The card has no cv2, and the JAX package draws its debug images with it
(core/viz.py, topology/nodes.py). This module reproduces the calls those
drawings make, on uint8 images in place, at the LINE_8 line type:

  * `line`, `polylines`, `rectangle`, `circle` (filled) and
    `draw_contours` (closed polygons) through cpp/draw.cpp (g++ at
    first use), cv2's own fixed-point algorithms — LineIterator,
    clipLine, Line2, FillConvexPoly, Circle, ThickLine with its round
    joints, PolyLine — with XY_SHIFT = 16 fractional bits, and one step
    cv2 5.0.0 adds: a line thicker than 1 is clipped to the image
    widened by the thickness before it is drawn;
  * `put_text` and `get_text_size` — FONT_HERSHEY_SIMPLEX at the sizes
    core/hershey.py holds: glyph coverage maps blended one after another,
    (dst·(255 − a) + colour·a + 127) // 255, at integer advances; nothing
    is drawn when the origin lies right of the image, as in cv2.

The tests hold every function against cv2 here.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from . import hershey
from .native import build_library

_SRC = Path(__file__).resolve().parent / "cpp" / "draw.cpp"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = build_library(_SRC, "cvdraw")
    lib.cv_draw_polyline.argtypes = [_P, _I, _I, _I, _P, _I, _I, _P, _I]
    lib.cv_draw_fill_convex.argtypes = [_P, _I, _I, _I, _P, _I, _P]
    lib.cv_draw_circle_filled.argtypes = [_P, _I, _I, _I, _L, _L, _L, _P]
    for fn in (lib.cv_draw_polyline, lib.cv_draw_fill_convex, lib.cv_draw_circle_filled):
        fn.restype = None
    return lib


def load_library() -> None:
    """Build (at first use) and load the native rasteriser."""
    _library()


def _target(img: np.ndarray):
    """(pointer, h, w, channels) of a C-contiguous uint8 image."""
    if img.dtype != np.uint8 or not img.flags.c_contiguous or img.ndim not in (2, 3):
        raise ValueError("draw: images are C-contiguous uint8 (H, W) or (H, W, C) arrays")
    return img.ctypes.data, img.shape[0], img.shape[1], 1 if img.ndim == 2 else img.shape[2]


def _color(img: np.ndarray, color) -> np.ndarray:
    """The colour as cv2 takes a Scalar: rounded, saturated, one value a
    channel."""
    ch = 1 if img.ndim == 2 else img.shape[2]
    vals = np.resize(np.asarray(color, np.float64).ravel(), max(ch, 1))[:ch]
    return np.ascontiguousarray(np.clip(np.rint(vals), 0, 255).astype(np.uint8))


def _points(pts) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(pts, np.int64).reshape(-1, 2))


def polylines(img: np.ndarray, pts, closed: bool, color, thickness: int = 1) -> np.ndarray:
    """cv2.polylines of one polygon (integer points, any (…, 2) shape)."""
    v = _points(pts)
    col = _color(img, color)
    _library().cv_draw_polyline(*_target(img), v.ctypes.data, len(v), int(bool(closed)),
                                col.ctypes.data, int(thickness))
    return img


def line(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """cv2.line(img, p1, p2, color, thickness) at LINE_8."""
    return polylines(img, [p1, p2], False, color, thickness)


def rectangle(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """cv2.rectangle: the outline as a closed polyline, thickness −1 filled."""
    (x1, y1), (x2, y2) = tuple(map(int, p1)), tuple(map(int, p2))
    pts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    if thickness >= 0:
        return polylines(img, pts, True, color, thickness)
    v, col = _points(pts), _color(img, color)
    _library().cv_draw_fill_convex(*_target(img), v.ctypes.data, len(v), col.ctypes.data)
    return img


def circle(img: np.ndarray, center, radius: int, color, thickness: int = -1) -> np.ndarray:
    """cv2.circle, filled (thickness −1) at LINE_8 — the one form the
    drawings use."""
    if thickness >= 0:
        raise NotImplementedError("only filled circles (thickness -1) are drawn")
    cx, cy = map(int, center)
    col = _color(img, color)
    _library().cv_draw_circle_filled(*_target(img), cx, cy, int(radius), col.ctypes.data)
    return img


def draw_contours(img: np.ndarray, contours, color, thickness: int = 1) -> np.ndarray:
    """cv2.drawContours(img, contours, -1, color, thickness) for
    thickness ≥ 1: each contour a closed polyline."""
    for ct in contours:
        polylines(img, ct, True, color, thickness)
    return img


def get_text_size(text: str, scale: float, thickness: int) -> tuple[tuple[int, int], int]:
    """cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, scale, thickness):
    ((width, height), baseline) — the advances plus one, the size's
    height, and the deepest glyph's reach below the baseline."""
    if not text:
        return (0, 0), 0
    g = hershey.glyphs(scale, thickness)
    width = sum(g[c][0] for c in text) + 1
    below = max([dy + cov.shape[0] for c in text for _a, _dx, dy, cov in (g[c],) if cov.size]
                or [0])
    return (width, hershey.TEXT_HEIGHT[(scale, thickness)]), max(0, below)


def put_text(img: np.ndarray, text: str, org, scale: float, color,
             thickness: int = 1) -> np.ndarray:
    """cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, scale, color,
    thickness) at a size core/hershey.py holds; printable ASCII only."""
    x, y = map(int, org)
    h, w = img.shape[:2]
    if x >= w:
        return img
    g = hershey.glyphs(scale, thickness)
    col = _color(img, color).astype(np.int32)
    for c in text:
        adv, dx, dy, cov = g[c]
        x0, y0 = x + dx, y + dy
        ya, yb = max(y0, 0), min(y0 + cov.shape[0], h)
        xa, xb = max(x0, 0), min(x0 + cov.shape[1], w)
        if cov.size and ya < yb and xa < xb:
            a = cov[ya - y0:yb - y0, xa - x0:xb - x0].astype(np.int32)
            if img.ndim == 3:
                a = a[:, :, None]
            dst = img[ya:yb, xa:xb].astype(np.int32)
            img[ya:yb, xa:xb] = ((dst * (255 - a) + col * a + 127) // 255).astype(np.uint8)
        x += adv
    return img
