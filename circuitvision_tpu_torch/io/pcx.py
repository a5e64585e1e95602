"""PCX decoding as Pillow 12.1.0's PcxImagePlugin reads a file, then
convert("RGB").

  * 1 bit in 1 plane (1 is white); 1 bit in 2 or 4 planes, the header's
    16-colour palette (Pillow's "P;2L" and "P;4L" unpackers, after its
    decoder has moved the planes together); version 5 8-bit grey, or
    palette where the 769 bytes at the end start with 12 and hold another
    palette than the grey ramp; version 5 8-bit RGB in 3 planes (Pillow's
    "RGB;L": the planes moved together as its decoder moves them, which
    for a width of 1 or 3 with a padded stride it does not);
  * the run lengths of native/lzw.cpp; the stride ceil(width · bits / 8),
    made even where the header's differs, as Pillow takes it.

Other bit depths and plane counts raise `ImageFormatError` naming them, as
a file PIL cannot read does.
"""
from __future__ import annotations

import struct

import numpy as np

from .lzw import pcx_rle

_MAX_PIXELS = 2 * int(1024 * 1024 * 1024 // 4 // 3)


def _error(msg: str) -> Exception:
    from .image_io import ImageFormatError
    return ImageFormatError(f"PCX: {msg}")


def looks_like_pcx(data: bytes) -> bool:
    """Pillow's PCX _accept."""
    return len(data) >= 2 and data[0] == 10 and data[1] in (0, 2, 3, 5)


def decode_pcx(data: bytes) -> np.ndarray:
    """PCX bytes → (H, W, 3) uint8 RGB."""
    if len(data) < 128:
        raise _error("truncated header")
    x0, y0, x1, y1 = struct.unpack_from("<4H", data, 4)
    w, h = x1 + 1 - x0, y1 + 1 - y0
    if w <= 0 or h <= 0:
        raise _error("bad PCX image size")
    if w * h > _MAX_PIXELS:
        raise _error(f"{w} x {h} pixels is over PIL's decompression-bomb limit")
    version, bits, planes = data[1], data[3], data[65]
    (given,) = struct.unpack_from("<H", data, 66)
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "planes"
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise _error(f"unknown PCX mode (version {version}, {bits} bits, {planes} planes)")
    stride = (w * bits + 7) // 8
    if given != stride:
        stride += stride % 2
    try:
        lines = pcx_rle(data[128:], planes * stride, h)
    except ValueError as exc:
        raise _error(str(exc)) from None
    if mode == "1":
        bit = np.unpackbits(lines, axis=1)[:, :w]
        return np.repeat((bit * 255).astype(np.uint8)[:, :, None], 3, axis=2)
    if mode == "planes":  # Pillow's decoder moves plane k from k · stride to k · ceil(w / 8)
        s = (w + 7) // 8
        idx = sum(np.unpackbits(lines[:, k * stride:k * stride + s], axis=1)[:, :w]
                  .astype(np.int32) << k for k in range(planes))
        palette = np.frombuffer(data[16:64], np.uint8).reshape(16, 3)
        return palette[idx]
    if mode == "L":
        grey = lines[:, :w]
        tail = data[-769:]
        ramp = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
        if len(data) >= 769 and tail[0] == 12 and tail[1:] != ramp:
            return np.frombuffer(tail[1:], np.uint8).reshape(256, 3)[grey]
        return np.repeat(grey[:, :, None], 3, axis=2)
    buf = lines.copy()  # "RGB;L": Pillow's decoder moves the planes together first
    size = planes * stride
    if size % w and size > w:
        bands = size // w
        step = size // bands
        for i in range(1, bands):
            buf[:, i * w:i * w + w] = buf[:, i * step:i * step + w].copy()
    return np.stack([buf[:, 0:w], buf[:, w:2 * w], buf[:, 2 * w:3 * w]], axis=2)
