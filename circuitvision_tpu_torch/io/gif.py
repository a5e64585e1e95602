"""GIF decoding as Pillow 12.1.0's GifImagePlugin reads a file's first
frame, then convert("RGB").

  * GIF87a and GIF89a; the logical screen's size, grown to hold a frame
    that reaches past it;
  * the global palette, and a frame's local palette in its place; a
    palette whose entries are a grey ramp (entry i = (i, i, i)) is
    dropped, and the frame then reads as grey levels (mode "L"), unless a
    local grey ramp drops to a global palette, which loading puts on the
    image; indices past the palette are black;
  * the first graphic control extension's transparent index: the canvas
    outside the frame is filled with it (else with index 0), rendered as
    its palette colour, as convert("RGB") renders a P image;
  * LZW (native/lzw.cpp) with interlaced rows in the four passes' order;
    an image whose codes end (at the end code, the sub-blocks'
    terminator or the file's end) before its last pixel raises, as
    PIL's "image file is truncated" does.

A file PIL cannot read raises `ImageFormatError` naming the reason.
"""
from __future__ import annotations

import struct

import numpy as np

from .lzw import gif_lzw

_MAX_PIXELS = 2 * int(1024 * 1024 * 1024 // 4 // 3)
_PASSES = ((0, 8), (4, 8), (2, 4), (1, 2))


def _error(msg: str) -> Exception:
    from .image_io import ImageFormatError
    return ImageFormatError(f"GIF: {msg}")


def _palette(p: bytes):
    """PIL's _is_palette_needed: None for a grey ramp, else the entries as
    a 256-entry RGB table, black past the file's."""
    if all(i // 3 == p[i] == p[i + 1] == p[i + 2] for i in range(0, len(p) - 2, 3)) \
            and len(p) % 3 == 0:
        return None
    n = len(p) // 3
    lut = np.zeros((256, 3), np.uint8)
    lut[:min(n, 256)] = np.frombuffer(p[:3 * min(n, 256)], np.uint8).reshape(-1, 3)
    return lut


def _sub_block(data: bytes, pos: int):
    """PIL's GifImageFile.data(): (the next sub-block or None at a
    terminator or the end, position after it)."""
    if pos >= len(data) or data[pos] == 0:
        return None, min(pos + 1, len(data))
    n = data[pos]
    return data[pos + 1:pos + 1 + n], pos + 1 + n


def decode_gif(data: bytes) -> np.ndarray:
    """GIF bytes → (H, W, 3) uint8 RGB of the first frame."""
    if len(data) < 13 or data[:6] not in (b"GIF87a", b"GIF89a"):
        raise _error("not a GIF file")
    width, height = struct.unpack_from("<HH", data, 6)
    flags, pos = data[10], 13
    global_lut = None
    if flags & 128:
        p = data[pos:pos + (3 << ((flags & 7) + 1))]
        pos += 3 << ((flags & 7) + 1)
        global_lut = _palette(p)
    if pos >= len(data) or data[pos:pos + 1] == b";":
        raise _error("no more images in GIF file")
    transparency = frame = None
    while pos < len(data):
        s = data[pos]
        pos += 1
        if s == 0x3B:
            break
        if s == 0x21:
            label = data[pos] if pos < len(data) else 0
            block, pos = _sub_block(data, pos + 1)
            if label == 0xF9 and block is not None:
                if block[0] & 1:
                    if len(block) < 4:
                        raise _error("truncated graphic control extension")
                    transparency = block[3]
            elif label == 0xFE:
                while block:
                    block, pos = _sub_block(data, pos)
                continue
            while True:
                block, pos = _sub_block(data, pos)
                if not block:
                    break
        elif s == 0x2C:
            if pos + 9 > len(data):
                raise _error("truncated image descriptor")
            x0, y0, fw, fh, fflags = struct.unpack_from("<HHHHB", data, pos)
            pos += 9
            lut = global_lut
            if fflags & 128:
                n = 3 << ((fflags & 7) + 1)
                # a local grey ramp leaves the frame in mode "L", and
                # loading puts the global palette on it, as on a P image
                lut = _palette(data[pos:pos + n])
                lut = global_lut if lut is None else lut
                pos += n
            if pos >= len(data):
                raise _error("image file is truncated (no LZW code size)")
            frame = (x0, y0, fw, fh, bool(fflags & 64), lut, data[pos])
            pos += 1
            break
    if frame is None:
        raise _error("image not found in GIF frame")
    x0, y0, fw, fh, interlace, lut, min_bits = frame
    width, height = max(width, x0 + fw), max(height, y0 + fh)
    if width * height > _MAX_PIXELS:
        raise _error(f"{width} x {height} pixels is over PIL's decompression-bomb limit")
    if min_bits > 11:
        raise _error(f"LZW minimum code size {min_bits} is over 11")

    chunks = []
    while pos < len(data) and data[pos]:
        chunks.append(data[pos + 1:pos + 1 + data[pos]])
        pos += 1 + data[pos]
    try:
        idx, _ended = gif_lzw(b"".join(chunks), min_bits, fw * fh)
    except ValueError as exc:
        raise _error(f"broken LZW stream: {exc}") from None
    if len(idx) < fw * fh:
        raise _error(f"image file is truncated ({len(idx)} of {fw * fh} pixels)")

    canvas = np.full((height, width), transparency or 0, np.uint8)
    if fw and fh:
        rows = np.arange(fh)
        if interlace:
            rows = np.concatenate([np.arange(start, fh, step) for start, step in _PASSES])
        canvas[y0:y0 + fh, x0:x0 + fw][rows] = idx.reshape(fh, fw)
    if lut is None:
        return np.repeat(canvas[:, :, None], 3, axis=2)
    return lut[canvas]
