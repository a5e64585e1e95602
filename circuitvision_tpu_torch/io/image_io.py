"""Host image ingest without PIL or cv2: PNG decode + EXIF orientation.

Counterpart of the JAX package's `io/image_io.py:19-35` (`decode_image`,
`load_image`), which decodes through PIL: bytes → RGB uint8, rotated by
the EXIF orientation (tag 0x0112) as `ImageOps.exif_transpose` rotates.
The card's machine has no PIL, so this module reads PNG itself with
zlib, numpy and the row unfilter of native/png.cpp (built with g++ at
first use). It reads what the repo's eval data holds and what PIL's
`convert("RGB")` makes of it:

  * 8-bit, non-interlaced PNG of colour type 0 (grey, copied to three
    channels), 2 (RGB) or 6 (RGBA, alpha dropped); all five row filters;
  * the orientation in an `eXIf` chunk (TIFF data, either byte order),
    applied for values 2-8, 1 and any other value leaving the image as it
    is; an `eXIf` chunk that does not parse leaves it too, as the JAX
    package's `except Exception: pass` around PIL's reading does.

Anything else — another format (JPEG stays in ROADMAP Queue A 9), 16-bit
or palette PNG, interlacing, EXIF in a text chunk — raises
`ImageFormatError` naming it. `read_png` gives the decoded samples
without conversion, as `np.asarray(PIL.Image.open(path))` does for the
eval masks.
"""
from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from pathlib import Path

import numpy as np

from ..core.native import build_library

ORIENTATION_TAG = 0x0112
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: channels of each colour type read
_CHANNELS = {0: 1, 2: 3, 6: 4}
_SRC = Path(__file__).resolve().parent / "native" / "png.cpp"
#: the text chunk keyword under which some writers put EXIF (PIL reads it)
_RAW_EXIF_KEYWORD = b"Raw profile type exif\x00"


class ImageFormatError(ValueError):
    """The bytes are not a PNG this reader takes."""


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = build_library(_SRC, "cvpng")
    lib.cv_png_unfilter.restype = ctypes.c_int
    lib.cv_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    return lib


def _chunks(data: bytes):
    """(type, body) of each chunk, CRCs checked, through IEND."""
    if not data.startswith(PNG_SIGNATURE):
        head = data[:4]
        kind = "JPEG" if head[:3] == b"\xff\xd8\xff" else f"bytes starting {head!r}"
        raise ImageFormatError(f"not a PNG ({kind}); only PNG is read")
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 12 > len(data):
            raise ImageFormatError("PNG: truncated before IEND")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ImageFormatError(f"PNG: chunk {kind!r} runs past the end")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ImageFormatError(f"PNG: CRC mismatch in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length


def _parse(data: bytes) -> tuple[np.ndarray, bytes | None]:
    """Decoded samples, (H, W) or (H, W, C), and the eXIf chunk's body."""
    header, idat, exif = None, [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            exif = body
        elif kind == b"PLTE":
            raise ImageFormatError("PNG: palette images are not read")
        elif kind in (b"tEXt", b"zTXt", b"iTXt") and body.startswith(_RAW_EXIF_KEYWORD):
            raise ImageFormatError("PNG: EXIF in a text chunk is not read")
    if header is None or not idat:
        raise ImageFormatError("PNG: no IHDR or no IDAT")
    w, h, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS:
        raise ImageFormatError(f"PNG: bit depth {depth}, colour type {colour}; only 8-bit "
                               f"colour types 0, 2 and 6 are read")
    if interlace:
        raise ImageFormatError("PNG: interlaced images are not read")
    if compression or filtering or not w or not h:
        raise ImageFormatError(f"PNG: compression {compression}, filter method {filtering}, "
                               f"size {w}x{h}")
    bpp = _CHANNELS[colour]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ImageFormatError(f"PNG: {len(raw)} bytes of image data, {h * (stride + 1)} "
                               f"expected")
    out = np.empty((h, stride), np.uint8)
    bad = _library().cv_png_unfilter(raw, h, stride, bpp, out.ctypes.data)
    if bad:
        ftype = raw[(bad - 1) * (stride + 1)]
        raise ImageFormatError(f"PNG: row {bad - 1} has filter type {ftype}")
    return (out if bpp == 1 else out.reshape(h, w, bpp)), exif


def exif_orientation(exif: bytes) -> int:
    """The orientation tag of TIFF-structured EXIF data (with or without
    the "Exif\\0\\0" prefix), 1 when absent or unreadable."""
    try:
        if exif.startswith(b"Exif\x00\x00"):
            exif = exif[6:]
        order = {b"II": "<", b"MM": ">"}[exif[:2]]
        magic, ifd = struct.unpack(order + "HI", exif[2:8])
        if magic != 42:
            return 1
        (count,) = struct.unpack(order + "H", exif[ifd:ifd + 2])
        for i in range(count):
            tag, typ, n, value = struct.unpack(
                order + "HHI4s", exif[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
            if tag == ORIENTATION_TAG and n == 1 and typ in (3, 4):  # SHORT or LONG
                fmt, size = ("H", 2) if typ == 3 else ("I", 4)
                return struct.unpack(order + fmt, value[:size])[0]
    except (KeyError, struct.error):
        pass
    return 1


def exif_transpose(img: np.ndarray, orientation: int) -> np.ndarray:
    """`PIL.ImageOps.exif_transpose` on an (H, W, ...) array."""
    if orientation == 2:
        return img[:, ::-1]
    if orientation == 3:
        return img[::-1, ::-1]
    if orientation == 4:
        return img[::-1]
    if orientation == 5:
        return img.swapaxes(0, 1)
    if orientation == 6:
        return np.rot90(img, -1)
    if orientation == 7:
        return img[::-1, ::-1].swapaxes(0, 1)
    if orientation == 8:
        return np.rot90(img, 1)
    return img


def read_png(path: str) -> np.ndarray:
    """The PNG's samples as stored: (H, W) grey, (H, W, 3) RGB or
    (H, W, 4) RGBA uint8, no orientation applied."""
    with open(path, "rb") as f:
        return _parse(f.read())[0]


def decode_image(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, 3) RGB uint8, EXIF-rotated."""
    img, exif = _parse(data)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    elif img.shape[2] == 4:
        img = img[:, :, :3]
    if exif is not None:
        img = exif_transpose(img, exif_orientation(exif))
    return np.ascontiguousarray(img)


def load_image(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image(f.read())
