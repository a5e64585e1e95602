"""Windows icon and cursor decoding as Pillow 12.1.0's IcoImagePlugin and
CurImagePlugin read a file, then convert("RGB").

  * ICO: the entry PIL loads first — the directory sorted by colour depth
    (the bit count, else log2 of the colour count, else 256), then,
    stably, by area, largest first; a width or height byte of 0 is 256;
  * the entry's image: a PNG (read as io/image_io reads PNG) or a DIB
    (io/bmp.decode_dib: the lower half of the stored rows); the DIB's AND
    mask or 32-bit alpha only sets alpha, which convert("RGB") drops, but
    a mask that the file cuts short raises as PIL's read of it does;
  * CUR: the first entry, replaced by each later one wider and taller in
    its directory bytes; its DIB as for ICO, with no mask.

A file PIL cannot read raises `ImageFormatError` naming the reason.
"""
from __future__ import annotations

import math
import struct

import numpy as np

from .bmp import decode_dib

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _error(msg: str) -> Exception:
    from .image_io import ImageFormatError
    return ImageFormatError(f"ICO: {msg}")


def _entries(data: bytes) -> list[tuple]:
    if len(data) < 6:
        raise _error("truncated header")
    n = struct.unpack_from("<H", data, 4)[0]
    out = []
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise _error("truncated directory")
        w, h, colours = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (colours != 0 and math.ceil(math.log(colours, 2))) or 256
        out.append((w, h, bpp, size, offset, depth))
    return out


def decode_ico(data: bytes) -> np.ndarray:
    """ICO bytes → (H, W, 3) uint8 RGB of the entry PIL loads."""
    from .image_io import _parse_png, _png_rgb

    entries = sorted(sorted(_entries(data), key=lambda e: e[5]),
                     key=lambda e: e[0] * e[1], reverse=True)
    if not entries:
        raise _error("the directory lists no image")
    _w, _h, bpp, size, offset, _depth = entries[0]
    if data[offset:offset + 8] == PNG_SIGNATURE:
        (_pw, _ph, depth, colour), samples, palette, _info = _parse_png(data[offset:])
        return _png_rgb(samples, depth, colour, palette)
    rgb = decode_dib(data, offset)
    h, w = rgb.shape[:2]
    if bpp == 32:
        need = w * h * 4
        header = struct.unpack_from("<I", data, offset)[0]
        if len(data) - (offset + header) < need:
            raise _error("not enough image data for the alpha of a 32-bit entry")
    else:
        padded = w + (32 - w % 32) % 32
        need = padded * h // 8
        start = offset + size - need
        if start < 0 or len(data[start:start + need]) < need:
            raise _error("not enough image data for the AND mask")
    return rgb


def decode_cur(data: bytes) -> np.ndarray:
    """CUR bytes → (H, W, 3) uint8 RGB of the entry PIL picks."""
    if len(data) < 6:
        raise _error("truncated cursor header")
    m = b""
    for i in range(struct.unpack_from("<H", data, 4)[0]):
        s = data[6 + 16 * i:22 + 16 * i]
        if not m:
            m = s
        elif len(s) >= 2 and s[0] > m[0] and s[1] > m[1]:
            m = s
    if len(m) < 16:
        raise _error("no cursors were found")
    return decode_dib(data, struct.unpack_from("<I", m, 12)[0])
