"""Netpbm decoding as Pillow 12.1.0's PpmImagePlugin reads a file, then
convert("RGB").

  * P1 and P4 bitmaps (1 is black), P2 and P5 grey maps, P3 and P6 pixel
    maps; header tokens split by whitespace, "#" comments running to the
    end of the line;
  * maxval 1 to 65535: samples scale as round(v / maxval · 255) (Python's
    rounding, half to even); a grey map with maxval over 255 is PIL's
    32-bit mode "I", scaled to 65535, which convert("RGB") clips at 255;
    binary samples are two bytes, big-endian, past maxval 255;
  * the plain (ASCII) formats' tokens, "0"/"1" characters of P1 with or
    without whitespace, comments anywhere;
  * Pillow's own variants: "Pf" (32-bit float grey, little-endian when
    the scale is negative, rows bottom-up; PIL's "F", clamped to 0-255
    and truncated), "PyRGBA" (alpha dropped), "PyCMYK" and "P0CMYK"
    (PIL's CMYK conversion), and "PyP", a palette image with no palette,
    which PIL converts to black.

A file PIL cannot read raises `ImageFormatError` naming the reason.
"""
from __future__ import annotations

import re

import numpy as np

_WHITESPACE = b" \t\n\x0b\x0c\r"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
          b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"RGB": 3, "RGBA": 4, "CMYK": 4}
_MAX_PIXELS = 2 * int(1024 * 1024 * 1024 // 4 // 3)


def _error(msg: str) -> Exception:
    from .image_io import ImageFormatError
    return ImageFormatError(f"PNM: {msg}")


def _token(data: bytes, pos: int) -> tuple[bytes, int]:
    """PIL's _read_token: the next token of up to 10 bytes and the
    position after the whitespace that ends it."""
    token = b""
    while len(token) <= 10:
        if pos >= len(data):
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            pos += 1
            continue
        token += c
    if not token:
        raise _error("reached EOF while reading header")
    if len(token) > 10:
        raise _error(f"token too long in file header: {token!r}")
    return token, pos


def _int(token: bytes) -> int:
    try:
        return int(token)
    except ValueError:
        raise _error(f"header token {token!r} is not an integer") from None


def _plain_body(data: bytes) -> bytes:
    """The body with PIL's comment rule: "#" to the next CR or LF."""
    return re.sub(rb"#[^\r\n]*(?:[\r\n]|$)", b"", data)


def decode_pnm(data: bytes) -> np.ndarray:
    """P1-P6 bytes → (H, W, 3) uint8 RGB."""
    magic = b""
    pos = 0
    while pos < min(len(data), 6):
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            break
        magic += c
    if magic not in _MODES:
        raise _error(f"{magic!r} is not read (not a PPM file)")
    mode = _MODES[magic]
    token, pos = _token(data, pos)
    w = _int(token)
    token, pos = _token(data, pos)
    h = _int(token)
    if w <= 0 or h <= 0:
        raise _error(f"image has no pixels ({w} x {h})")
    if w * h > _MAX_PIXELS:
        raise _error(f"{w} x {h} pixels is over PIL's decompression-bomb limit")
    bands = _BANDS.get(mode, 1)
    plain = magic in (b"P1", b"P2", b"P3")
    if mode == "F":
        return _pfm(data, pos, w, h)
    if mode == "1":
        if plain:
            bits = bytes(b for b in _plain_body(data[pos:]) if b not in _WHITESPACE)
            if any(b not in b"01" for b in bits[:w * h]):
                bad = next(b for b in bits[:w * h] if b not in b"01")
                raise _error(f"invalid token for this mode: {bytes([bad])!r}")
            if len(bits) < w * h:
                raise _error("not enough image data")
            grey = np.where(np.frombuffer(bits[:w * h], np.uint8) == ord("1"), 0, 255)
            grey = grey.astype(np.uint8).reshape(h, w)
        else:
            stride = (w + 7) // 8
            raw = data[pos:pos + stride * h]
            if len(raw) < stride * h:
                raise _error("image file is truncated")
            rows = np.frombuffer(raw, np.uint8).reshape(h, stride)
            grey = np.where(np.unpackbits(rows, axis=1)[:, :w] == 1, 0, 255).astype(np.uint8)
        return np.repeat(grey[:, :, None], 3, axis=2)
    token, pos = _token(data, pos)
    maxval = _int(token)
    if not 0 < maxval < 65536:
        raise _error("maxval must be greater than 0 and less than 65536")
    wide = mode == "L" and maxval > 255  # PIL's mode "I"
    out_max = 65535 if wide else 255
    n = w * h * bands
    if plain:
        tokens = _plain_body(data[pos:]).split()
        if any(len(t) > 10 for t in tokens[:n]):
            raise _error("token too long found in data")
        values = np.asarray([_int(t) for t in tokens[:n]], np.int64)
        if (values < 0).any():
            raise _error("channel value is negative")
        if (values > maxval).any():
            raise _error("channel value too large for this mode")
        if len(values) < n:
            raise _error("not enough image data")
        scaled = np.round(values / maxval * out_max)
    elif maxval == 255:
        raw = data[pos:pos + n]
        if len(raw) < n:
            raise _error("image file is truncated")
        scaled = np.frombuffer(raw, np.uint8)
    elif wide and maxval == 65535:
        raw = data[pos:pos + 2 * n]
        if len(raw) < 2 * n:
            raise _error("image file is truncated")
        scaled = np.frombuffer(raw, ">u2")
    else:
        size = 1 if maxval < 256 else 2
        raw = data[pos:pos + size * n]
        got = len(raw) // (size * bands) * bands
        values = np.frombuffer(raw[:got * size], np.uint8 if size == 1 else ">u2")
        scaled = np.minimum(out_max, np.round(values / maxval * out_max))
        if got < n:
            raise _error("not enough image data")
    samples = np.minimum(scaled, 255).astype(np.uint8).reshape(h, w, bands)
    if mode == "P":  # no palette in the file: PIL's conversion gives black
        return np.zeros((h, w, 3), np.uint8)
    if mode == "CMYK":
        from .image_io import cmyk_to_rgb
        return cmyk_to_rgb(255 - samples)
    return samples[:, :, :3] if bands > 1 else np.repeat(samples, 3, axis=2)


def _pfm(data: bytes, pos: int, w: int, h: int) -> np.ndarray:
    """Pf: the scale token (its sign the byte order), float32 rows bottom-up."""
    token, pos = _token(data, pos)
    try:
        scale = float(token)
    except ValueError:
        raise _error(f"header token {token!r} is not a number") from None
    if scale == 0.0 or not np.isfinite(scale):
        raise _error("scale must be finite and non-zero")
    raw = data[pos:pos + 4 * w * h]
    if len(raw) < 4 * w * h:
        raise _error("image file is truncated")
    v = np.frombuffer(raw, "<f4" if scale < 0 else ">f4").reshape(h, w)[::-1]
    v = np.nan_to_num(v.astype(np.float64), nan=0.0, posinf=255.0, neginf=0.0)
    return np.repeat(np.clip(v, 0, 255).astype(np.uint8)[:, :, None], 3, axis=2)
