"""WebP decoding as Pillow 12.1.0 reads a file (libwebp 1.6.0's
WebPAnimDecoder, MODE_RGBA), then convert("RGB").

The RIFF container is parsed here as libwebp's demuxer parses it; the
bitstreams (VP8L lossless, VP8 lossy and its ALPH alpha) are decoded by
native/webp.cpp (g++ at first use). What this gives:

  * a simple file (one "VP8 " or "VP8L" chunk), or an extended one
    ("VP8X" first) holding one still image, its optional ALPH chunk read
    only when the VP8X alpha flag is set, as the demuxer reads it;
  * an animation: the first frame of the first "ANMF" chunk, decoded into
    a transparent black canvas at its offset (the first frame is a key
    frame, never blended), so pixels outside the frame are black; every
    frame's container structure is checked, as the demuxer checks it;
  * RGB under transparent pixels as the decoder wrote it (not
    premultiplied);
  * the EXIF and XMP chunks of an extended file whose flags announce them
    (the first of each), as PIL's info["exif"] and info["xmp"], which the
    reader's orientation step reads as PIL's getexif() does.

A file PIL cannot read raises `ImageFormatError` naming the reason.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path

import numpy as np

from ..core.native import build_library

_NATIVE = Path(__file__).resolve().parent / "native"
#: VP8X flags
_ALPHA, _EXIF, _XMP, _ANIMATION = 0x10, 0x08, 0x04, 0x02
_IMAGE = (b"VP8 ", b"VP8L")


def _error(msg: str) -> Exception:
    from .image_io import ImageFormatError
    return ImageFormatError(f"WebP: {msg}")


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = build_library(_NATIVE / "webp.cpp", "cvwebp")
    lib.cv_webp_frame_info.restype = ctypes.c_int
    lib.cv_webp_frame_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.cv_webp_frame_decode.restype = ctypes.c_int
    lib.cv_webp_frame_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                         ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                         ctypes.c_char_p, ctypes.c_int]
    return lib


def _chunks(data: bytes, pos: int, end: int):
    """(fourcc, payload) of each chunk from pos to end; a chunk, or its pad
    byte, that runs past the end raises (the demuxer wants more data)."""
    while pos < end:
        if end - pos < 8:
            raise _error("truncated chunk header")
        fourcc = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        padded = size + (size & 1)
        if pos + 8 + padded > end:
            raise _error(f"chunk {fourcc!r} runs past the end of the file")
        yield fourcc, data[pos + 8:pos + 8 + size]
        pos += 8 + padded


class _Frame:
    """An image chunk and the ALPH chunk before it."""

    def __init__(self, kind: bytes, payload: bytes, alpha):
        self.lossless, self.payload, self.alpha = kind == b"VP8L", payload, alpha
        dims = np.zeros(2, np.int32)
        err = ctypes.create_string_buffer(256)
        if _library().cv_webp_frame_info(payload, len(payload), int(self.lossless),
                                         dims.ctypes.data, err, len(err)):
            raise _error(err.value.decode().removeprefix("WebP: "))
        self.width, self.height = int(dims[0]), int(dims[1])

    def decode(self) -> np.ndarray:
        """(height, width, 4) RGBA."""
        out = np.empty((self.height, self.width, 4), np.uint8)
        err = ctypes.create_string_buffer(256)
        alpha = self.alpha
        if _library().cv_webp_frame_decode(self.payload, len(self.payload), int(self.lossless),
                                           alpha, 0 if alpha is None else len(alpha),
                                           out.ctypes.data, err, len(err)):
            raise _error(err.value.decode().removeprefix("WebP: "))
        return out


def _frame(chunks: list, keep_alpha: bool = True) -> tuple[_Frame, int]:
    """(frame, chunks it took): what the demuxer's StoreFrame reads from a
    run of chunks, an optional ALPH and then the image chunk. A still
    image drops its ALPH unless the VP8X alpha flag is set
    (ParseSingleImage); an ALPH before a lossless image is an error
    either way."""
    alpha = None
    for n, (kind, payload) in enumerate(chunks):
        if kind == b"ALPH" and alpha is None:
            alpha = payload
        elif kind in _IMAGE:
            if kind == b"VP8L" and alpha is not None:
                raise _error("an ALPH chunk before a lossless image")
            return _Frame(kind, payload, alpha if keep_alpha else None), n + 1
        else:
            break
    raise _error("a frame without an image chunk")


def _anmf(payload: bytes):
    """(x, y, frame) of an ANMF chunk."""
    if len(payload) < 16:
        raise _error("ANMF chunk too short")
    x = 2 * int.from_bytes(payload[0:3], "little")
    y = 2 * int.from_bytes(payload[3:6], "little")
    return x, y, _frame(list(_chunks(payload, 16, len(payload))))[0]


def decode_webp_rgba(data: bytes) -> tuple[np.ndarray, dict]:
    """(canvas RGBA as WebPAnimDecoder gives its first frame, PIL-style
    info dict with "exif" and "xmp")."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise _error("not a RIFF WEBP file")
    if data[12:16] not in (b"VP8 ", b"VP8L", b"VP8X"):
        raise _error(f"first chunk {data[12:16]!r} is not VP8, VP8L or VP8X")
    (riff_size,) = struct.unpack_from("<I", data, 4)
    end = riff_size + 8
    if riff_size < 12 or len(data) < end:
        raise _error(f"RIFF size {riff_size} and a file of {len(data)} bytes")
    chunks = list(_chunks(data, 12, end))
    info: dict = {}
    if chunks[0][0] != b"VP8X":
        return _frame(chunks)[0].decode(), info
    vp8x = chunks[0][1]
    if len(vp8x) < 10:
        raise _error("VP8X chunk too short")
    flags = vp8x[0]
    width = 1 + int.from_bytes(vp8x[4:7], "little")
    height = 1 + int.from_bytes(vp8x[7:10], "little")
    if width * height >= 1 << 32:
        raise _error(f"canvas of {width} x {height}")
    animated = bool(flags & _ANIMATION)
    frames, still, anim = [], None, False
    rest = chunks[1:]
    i = 0
    while i < len(rest):
        kind, payload = rest[i]
        if kind == b"VP8X":
            raise _error("a second VP8X chunk")
        if kind in (b"ALPH",) + _IMAGE:
            if anim or animated or still is not None:
                raise _error("an image chunk outside a frame of an animation")
            still, taken = _frame(rest[i:], keep_alpha=bool(flags & _ALPHA))
            i += taken
            continue
        if kind == b"ANIM":
            if len(payload) < 6:
                raise _error("ANIM chunk too short")
            anim = True
        elif kind == b"ANMF":
            if not anim:
                raise _error("an ANMF chunk before the ANIM chunk")
            frames.append(_anmf(payload))
        elif kind == b"EXIF" and flags & _EXIF:
            info.setdefault("exif", payload)
        elif kind == b"XMP " and flags & _XMP:
            info.setdefault("xmp", payload)
        i += 1
    if animated:
        if not frames:
            raise _error("an animation without frames")
        for x, y, f in frames:
            if x + f.width > width or y + f.height > height:
                raise _error(f"a {f.width} x {f.height} frame at ({x}, {y}) outside the "
                             f"{width} x {height} canvas")
        x, y, first = frames[0]
        canvas = np.zeros((height, width, 4), np.uint8)
        canvas[y:y + first.height, x:x + first.width] = first.decode()
        return canvas, info
    if still is None:
        raise _error("an extended file without an image")
    if (still.width, still.height) != (width, height):
        raise _error(f"a {still.width} x {still.height} image on a {width} x {height} canvas")
    return still.decode(), info


def decode_webp(data: bytes) -> tuple[np.ndarray, dict]:
    """(RGB uint8 image before orientation, PIL-style info dict)."""
    rgba, info = decode_webp_rgba(data)
    return np.ascontiguousarray(rgba[:, :, :3]), info
