"""Truevision TGA decoding as Pillow 12.1.0's TgaImagePlugin reads a file,
then convert("RGB").

  * image types 1 (colour-mapped), 2 (true colour), 3 (grey) and their
    RLE forms 9, 10 and 11; pixel depths 1 (grey only), 8, 16, 24 and 32
    — PIL takes no other depth, 15 included;
  * 16-bit true colour as PIL's "BGRA;15Z" (5 bits a channel, v · 255 //
    31), 16-bit grey as grey + alpha, 32-bit as BGRA; alpha is dropped;
  * colour maps of 16 or 24 bits from their first entry index on,
    indices past the map black (PIL fails on a 32-bit map);
  * the origin bits: bottom-left (rows stored bottom-up) or top-left,
    and right-to-left mirrored;
  * RLE packets within a row; PIL refuses one that runs past its row.

There is no magic number: `looks_like_tga` holds the header fields PIL's
open checks. A file PIL cannot read raises `ImageFormatError` naming the
reason.
"""
from __future__ import annotations

import struct

import numpy as np

_MAX_PIXELS = 2 * int(1024 * 1024 * 1024 // 4 // 3)
#: (image type & 7, depth) → PIL's raw mode
_RAW = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
        (2, 24): "BGR", (2, 32): "BGRA"}


def _error(msg: str) -> Exception:
    from .image_io import ImageFormatError
    return ImageFormatError(f"TGA: {msg}")


def looks_like_tga(data: bytes) -> bool:
    """The header checks of PIL's TgaImageFile._open."""
    if len(data) < 18:
        return False
    w, h = struct.unpack_from("<HH", data, 12)
    return data[1] in (0, 1) and w > 0 and h > 0 and data[16] in (1, 8, 16, 24, 32) \
        and data[2] in (1, 2, 3, 9, 10, 11) and data[17] & 0x30 in (0, 0x10, 0x20, 0x30)


def _bgr15(raw: np.ndarray) -> np.ndarray:
    """PIL's "BGRA;15Z" unpacker on flat little-endian pairs → (N, 3) RGB."""
    v = np.ascontiguousarray(raw).reshape(-1).view("<u2").astype(np.uint32)
    return (np.stack([(v >> 10) & 31, (v >> 5) & 31, v & 31], axis=-1) * 255 // 31
            ).astype(np.uint8)


def _rle(data: bytes, pos: int, npix: int, size: int, w: int) -> bytes:
    """PIL's TgaRleDecode: packets of up to 128 pixels; one that runs past
    the end of its row is a buffer overrun."""
    out = bytearray()
    need = npix * size
    while len(out) < need:
        if pos >= len(data):
            raise _error("image file is truncated (the RLE stream ends short)")
        head = data[pos]
        pos += 1
        count = (head & 0x7F) + 1
        if count > w - (len(out) // size) % w:
            raise _error("buffer overrun when reading image file (an RLE packet runs past "
                         "its row)")
        if head & 0x80:
            px = data[pos:pos + size]
            if len(px) < size:
                raise _error("image file is truncated (the RLE stream ends short)")
            out += px * count
            pos += size
        else:
            run = data[pos:pos + count * size]
            if len(run) < count * size:
                raise _error("image file is truncated (the RLE stream ends short)")
            out += run
            pos += count * size
    return bytes(out[:need])


def decode_tga(data: bytes) -> np.ndarray:
    """TGA bytes → (H, W, 3) uint8 RGB."""
    if not looks_like_tga(data):
        raise _error("not a TGA file")
    id_len, cmap_type, kind = data[0], data[1], data[2]
    w, h = struct.unpack_from("<HH", data, 12)
    depth, flags = data[16], data[17]
    if w * h > _MAX_PIXELS:
        raise _error(f"{w} x {h} pixels is over PIL's decompression-bomb limit")
    raw_mode = _RAW.get((kind & 7, depth))
    if raw_mode is None or (kind & 7 == 1 and not cmap_type):
        raise _error(f"image type {kind} at {depth} bits is not read (PIL cannot decode it)")
    pos = 18 + id_len
    lut = None
    if cmap_type and (kind & 7 == 2 or depth == 1):
        raise _error(f"a colour map on image type {kind} at {depth} bits (PIL cannot put a "
                     f"palette on it)")
    if cmap_type:
        start, size, map_depth = struct.unpack_from("<HHB", data, 3)
        step = {16: 2, 24: 3}.get(map_depth)
        if map_depth == 32:
            raise _error("a 32-bit colour map (PIL has no BGRA palette raw mode)")
        if step is None:
            raise _error(f"unknown colour map depth ({map_depth})")
        entries = np.frombuffer(data[pos:pos + step * size], np.uint8)
        entries = entries[:len(entries) // step * step].reshape(-1, step)
        pos += step * size
        colours = _bgr15(entries) if step == 2 else entries[:, 2::-1]
        lut = np.zeros((256, 3), np.uint8)
        lut[start:start + len(colours)] = colours[:max(0, 256 - start)]
    npix = w * h
    if depth == 1:
        stride = (w + 7) // 8
        if kind & 8:
            raise _error("RLE at 1 bit is not read (PIL cannot decode it)")
        raw = data[pos:pos + stride * h]
        if len(raw) < stride * h:
            raise _error("image file is truncated")
        rows = np.frombuffer(raw, np.uint8).reshape(h, stride)
        grey = np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
        rgb = np.repeat(grey[:, :, None], 3, axis=2)
    else:
        size = depth // 8
        if kind & 8:
            raw = _rle(data, pos, npix, size, w)
        else:
            raw = data[pos:pos + npix * size]
            if len(raw) < npix * size:
                raise _error("image file is truncated")
        px = np.frombuffer(raw, np.uint8).reshape(h, w, size)
        if raw_mode == "P" or (raw_mode in ("L", "LA") and lut is not None):
            # a grey image with a colour map becomes P when PIL loads it
            rgb = lut[px[:, :, 0]]
        elif raw_mode in ("L", "LA"):
            rgb = np.repeat(px[:, :, :1], 3, axis=2)
        elif raw_mode == "BGRA;15Z":
            rgb = _bgr15(px).reshape(h, w, 3)
        else:
            rgb = px[:, :, 2::-1]
    if not flags & 0x20:  # bottom-left origin: rows are stored bottom-up
        rgb = rgb[::-1]
    if flags & 0x10:
        rgb = rgb[:, ::-1]
    return np.ascontiguousarray(rgb)
