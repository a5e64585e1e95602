"""Outer-contour extraction with OpenCV-equivalent polygon semantics.

Counterpart of the JAX package's `topology/contours.py`. The reference's
node stage consumes cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)
through four quantities (src/circuit_analyzer.py:388-459, 1380-1446,
1470-1545, 1615-1633):

  1. enumeration order (node old-ids) — reverse raster discovery;
  2. cv2.contourArea — POLYGON area of the outer border (a ring's area
     includes its hole);
  3. cv2.moments m00/m10/m01 — Green's-theorem polygon moments;
  4. the CHAIN_APPROX_SIMPLE vertex list — the reference's terminal
     matching walks ONLY these direction-change points.

The tracer is the first-party C++ source native/contours.cpp (a copy of
the JAX package's), built with g++ into the package's build directory at
first use and called through ctypes. If it cannot be built, tracing
raises: the port has no slower fallback that would hide the fault.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import numpy as np

from ..core.native import build_library

_SRC = Path(__file__).resolve().parent / "native" / "contours.cpp"


@dataclasses.dataclass
class Contour:
    """One top-level outer contour (cv2-equivalent)."""

    vertices: np.ndarray  # (V, 2) int32 (x, y) CHAIN_APPROX_SIMPLE points
    area: float  # |polygon area| == cv2.contourArea
    m00: float  # signed polygon moments == cv2.moments
    m10: float
    m01: float
    rect: tuple[int, int, int, int]  # (xmin, ymin, xmax, ymax) inclusive
    #: raster-first linear pixel index of the component (y0 * W + x0)
    root: int = -1

    @property
    def centroid(self) -> tuple[int, int]:
        """int-truncated polygon centroid (reference :1620-1622). Kept
        contours have area > 0, so m00 != 0."""
        return int(self.m10 / self.m00), int(self.m01 / self.m00)


@functools.lru_cache(maxsize=1)
def load_library():
    """Build (once per source hash) and load the native tracer."""
    lib = build_library(_SRC, "cvcontours")
    lib.cv_trace_contours.restype = ctypes.c_int
    lib.cv_trace_contours.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
    ]
    return lib


_MAX_CONTOURS = 4096


def _cv2_vertex_order(verts: np.ndarray, root: int, w: int) -> np.ndarray:
    """Reorder an emitted vertex sequence into cv2's exact traversal.

    The chain walk emits direction-change vertices in the rotation
    opposite to cv2.findContours'; reversing reproduces cv2's sequence
    (the vertex SET is direction-invariant: a pixel is a vertex iff its
    in/out steps differ, which is symmetric under reversal). cv2 always
    emits the trace start — the component's raster-first pixel, our
    `root` — as the FIRST point, even when it lies mid-run (collinear);
    insert it if the reversal does not already lead with it."""
    if len(verts) < 2:
        return verts
    v = np.ascontiguousarray(verts[::-1])
    sx, sy = root % w, root // w
    if v[0, 0] == sx and v[0, 1] == sy:
        return v
    idx = np.nonzero((v[:, 0] == sx) & (v[:, 1] == sy))[0]
    if len(idx):
        return np.ascontiguousarray(np.roll(v, -int(idx[0]), axis=0))
    return np.ascontiguousarray(
        np.concatenate([np.asarray([[sx, sy]], v.dtype), v], axis=0)
    )


def trace_contours(fg: np.ndarray) -> list[Contour]:
    """Top-level outer contours of a boolean/0-255 raster, in cv2
    RETR_EXTERNAL output order (reverse raster discovery)."""
    fg_u8 = np.ascontiguousarray((np.asarray(fg) != 0).astype(np.uint8))
    h, w = fg_u8.shape
    lib = load_library()
    vert_cap = 2 * (h * w + 8)
    verts = np.empty(vert_cap, np.int32)
    offsets = np.empty(_MAX_CONTOURS + 1, np.int32)
    stats = np.empty(_MAX_CONTOURS * 9, np.float64)
    n = lib.cv_trace_contours(
        fg_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), vert_cap,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), _MAX_CONTOURS,
    )
    if n < 0:
        raise RuntimeError(f"contour tracer overflow (more than {_MAX_CONTOURS} contours)")
    out = []
    for k in range(n):
        s = stats[9 * k : 9 * k + 9]
        verts_k = verts[2 * offsets[k] : 2 * offsets[k + 1]].reshape(-1, 2).copy()
        out.append(Contour(
            vertices=_cv2_vertex_order(verts_k, int(s[8]), w),
            area=float(s[0]), m00=float(s[1]), m10=float(s[2]), m01=float(s[3]),
            rect=(int(s[4]), int(s[5]), int(s[6]), int(s[7])),
            root=int(s[8]),
        ))
    return out
