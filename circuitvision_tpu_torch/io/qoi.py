"""QOI decoding as Pillow 12.1.0's QoiImagePlugin reads a file, then
convert("RGB"): the header's width and height (big-endian), 3 channels
RGB and any other count RGBA; the operations RGB, RGBA, INDEX, DIFF, LUMA
and RUN over the previous pixel (0, 0, 0, 255 at the start) and the 64
pixels seen, hashed (r·3 + g·5 + b·7 + a·11) mod 64, as Pillow's decoder
runs them (an INDEX of a slot never filled is (0, 0, 0, 0)); alpha
dropped. A stream that ends early raises `ImageFormatError`, as it fails
in PIL.
"""
from __future__ import annotations

import struct

import numpy as np

_MAX_PIXELS = 2 * int(1024 * 1024 * 1024 // 4 // 3)


def _error(msg: str) -> Exception:
    from .image_io import ImageFormatError
    return ImageFormatError(f"QOI: {msg}")


def decode_qoi(data: bytes) -> np.ndarray:
    """QOI bytes → (H, W, 3) uint8 RGB."""
    if len(data) < 14 or data[:4] != b"qoif":
        raise _error("not a QOI file")
    w, h = struct.unpack_from(">II", data, 4)
    if w * h > _MAX_PIXELS:
        raise _error(f"{w} x {h} pixels is over PIL's decompression-bomb limit")
    need = w * h
    out = np.empty((need, 4), np.uint8)
    seen = [None] * 64
    prev = (0, 0, 0, 255)
    seen[(0 * 3 + 0 * 5 + 0 * 7 + 255 * 11) % 64] = prev
    pos, n, end = 14, 0, len(data)
    try:
        while n < need:
            byte = data[pos]
            pos += 1
            if byte == 0xFE:
                px = (data[pos], data[pos + 1], data[pos + 2], prev[3])
                if pos + 3 > end:
                    raise IndexError
                pos += 3
            elif byte == 0xFF:
                if pos + 4 > end:
                    raise IndexError
                px = tuple(data[pos:pos + 4])
                pos += 4
            elif byte < 0x40:  # INDEX
                px = seen[byte] or (0, 0, 0, 0)
            elif byte < 0x80:  # DIFF
                px = ((prev[0] + ((byte >> 4) & 3) - 2) % 256,
                      (prev[1] + ((byte >> 2) & 3) - 2) % 256,
                      (prev[2] + (byte & 3) - 2) % 256, prev[3])
            elif byte < 0xC0:  # LUMA
                second = data[pos]
                pos += 1
                dg = (byte & 0x3F) - 32
                px = ((prev[0] + dg + (second >> 4) - 8) % 256, (prev[1] + dg) % 256,
                      (prev[2] + dg + (second & 15) - 8) % 256, prev[3])
            else:  # RUN: the previous pixel again, not hashed again
                run = min((byte & 0x3F) + 1, need - n)
                out[n:n + run] = prev
                n += run
                continue
            prev = px
            seen[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64] = px
            out[n] = px
            n += 1
    except IndexError:
        raise _error(f"the stream ends after {n} of {need} pixels") from None
    return np.ascontiguousarray(out[:, :3].reshape(h, w, 3))
