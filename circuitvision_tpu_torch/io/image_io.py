"""Host image ingest without PIL or cv2: PNG and JPEG decode + EXIF orientation.

Counterpart of the JAX package's `io/image_io.py` (`decode_image`,
`load_image`, `format_exif_data`, `format_exif_value`), which decodes
through PIL: bytes → RGB uint8, rotated by the EXIF orientation (tag
0x0112) as `ImageOps.exif_transpose` rotates. The card's machine has no
PIL, so this module reads both formats itself and gives what PIL's
`convert("RGB")` makes of them (Pillow 12.1.0, libjpeg-turbo 3.1.3):

  * PNG with zlib and numpy, the row unfilter in native/png.cpp (g++ at
    first use): every colour type (grey, RGB, palette with or without
    tRNS, grey+alpha, RGBA; alpha dropped), bit depths 1, 2, 4, 8 and 16
    (PIL keeps a 16-bit sample's high byte; 16-bit grey goes through
    PIL's I;16 → L, which clips at 255), Adam7 interlacing;
  * JPEG with native/jpeg.cpp (g++ at first use): baseline and
    progressive Huffman, 8-bit, grey or YCbCr/RGB, sampling factors 1
    or 2, restart intervals, libjpeg-turbo's ISLOW IDCT, fancy
    upsampling, YCbCr tables and block smoothing of progressive scans
    left short of full precision. Arithmetic coding, 12-bit and lossless
    frames, CMYK/YCCK and other sampling factors raise `ImageFormatError`
    naming them (ROADMAP Queue A 9);
  * the orientation as `PIL.Image.getexif` finds it: the EXIF of a PNG
    `eXIf` chunk (or a `tEXt` "exif" chunk), else of a "Raw profile type
    exif" text chunk (hex), or of a JPEG's first APP1 "Exif" segment;
    where that holds no orientation tag, `tiff:Orientation` in the XMP
    (PNG: the "XML:com.adobe.xmp" text chunk; JPEG: the APP1 segment
    headed by the XMP namespace). Values 2-8 rotate; EXIF that does not
    parse leaves the image as it is, as the JAX package's
    `except Exception: pass` around PIL's reading does.

Anything else — BMP, WebP or another format — raises `ImageFormatError`
naming it. `read_png` gives an 8-bit grey, RGB or RGBA PNG's samples
without conversion, as `np.asarray(PIL.Image.open(path))` does for the
eval masks.
"""
from __future__ import annotations

import ctypes
import functools
import re
import struct
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.native import build_library

ORIENTATION_TAG = 0x0112
SOFTWARE_TAG = 0x0131
EXIF_IFD_TAG = 0x8769
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: channels of each PNG colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
#: bit depths each colour type may have (PNG specification, 11.2.2)
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
#: Adam7 passes: x start, y start, x step, y step
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_NATIVE = Path(__file__).resolve().parent / "native"
#: the text chunk keyword under which some writers put EXIF (PIL reads it)
_RAW_EXIF = "Raw profile type exif"
_XMP_KEY = "XML:com.adobe.xmp"
_XMP_ORIENTATION = r'tiff:Orientation(="|>)([0-9])'
_XMP_JPEG_HEAD = b"http://ns.adobe.com/xap/1.0/\x00"
#: the names format_exif_data keeps (PIL.ExifTags.TAGS)
_DISPLAY_TAGS = {SOFTWARE_TAG: "Software", ORIENTATION_TAG: "Orientation"}


class ImageFormatError(ValueError):
    """The bytes are not an image this reader takes."""


@functools.lru_cache(maxsize=1)
def _png_library() -> ctypes.CDLL:
    lib = build_library(_NATIVE / "png.cpp", "cvpng")
    lib.cv_png_unfilter.restype = ctypes.c_int
    lib.cv_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=1)
def _jpeg_library() -> ctypes.CDLL:
    lib = build_library(_NATIVE / "jpeg.cpp", "cvjpeg")
    for fn in (lib.cv_jpeg_info, lib.cv_jpeg_decode):
        fn.restype = ctypes.c_int
    lib.cv_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                 ctypes.c_char_p, ctypes.c_int]
    lib.cv_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                   ctypes.c_char_p, ctypes.c_int]
    return lib


def load_native() -> None:
    """Build (at first use) and load both host decoders."""
    _png_library()
    _jpeg_library()


def _format_name(data: bytes) -> str:
    if data.startswith(b"BM"):
        return "BMP"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    return f"bytes starting {data[:4]!r}"


# --------------------------------------------------------------------- PNG
def _chunks(data: bytes):
    """(type, body) of each chunk, CRCs checked, through IEND."""
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


def _png_text(kind: bytes, body: bytes, info: dict) -> None:
    """A text chunk into `info` as PIL's PngImagePlugin stores it (chunk_
    tEXt/zTXt/iTXt): latin-1 text, "exif" from tEXt kept as bytes, iTXt
    decoded as UTF-8 (its XMP key also as bytes under "xmp")."""
    key, sep, rest = body.partition(b"\x00")
    if kind == b"tEXt":
        if key:
            info[key.decode("latin-1")] = rest if key == b"exif" else rest.decode(
                "latin-1", "replace")
        return
    if kind == b"zTXt":
        if rest and rest[0] != 0:
            raise ImageFormatError(f"PNG: unknown compression method {rest[0]} in zTXt")
        try:
            text = zlib.decompress(rest[1:]) if rest else b""
        except zlib.error:
            text = b""
        if key:
            info[key.decode("latin-1")] = text.decode("latin-1", "replace")
        return
    # iTXt
    if not sep or len(rest) < 2:
        return
    flag, method, rest = rest[0], rest[1], rest[2:]
    parts = rest.split(b"\x00", 2)
    if len(parts) < 3:
        return
    lang, tkey, text = parts
    if flag:
        if method:
            return
        try:
            text = zlib.decompress(text)
        except zlib.error:
            return
    if key == _XMP_KEY.encode():
        info["xmp"] = text
    try:
        name = key.decode("latin-1")
        lang.decode("utf-8")
        tkey.decode("utf-8")
        info[name] = text.decode("utf-8")
    except UnicodeError:
        return


def _unpack(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered rows (h, stride) → samples (h, width·channels), uint8
    for depths up to 8 (unscaled), uint16 for 16."""
    if depth == 8:
        return rows[:, :width * channels]
    if depth == 16:
        return rows[:, :2 * width * channels].view(">u2").astype(np.uint16)
    bits = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, depth)[:, :width]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.empty((h, stride), np.uint8)
    bad = _png_library().cv_png_unfilter(raw, h, stride, bpp, out.ctypes.data)
    if bad:
        raise ImageFormatError(f"PNG: row {bad - 1} has filter type "
                               f"{raw[(bad - 1) * (stride + 1)]}")
    return out


def _png_samples(raw: bytes, w: int, h: int, depth: int, colour: int,
                 interlace: bool) -> np.ndarray:
    """(h, w, channels) samples of the decompressed image data."""
    ch = _CHANNELS[colour]
    bits = depth * ch
    bpp = max(1, bits // 8)
    if not interlace:
        stride = (w * bits + 7) // 8
        if len(raw) != h * (stride + 1):
            raise ImageFormatError(f"PNG: {len(raw)} bytes of image data, "
                                   f"{h * (stride + 1)} expected")
        return _unpack(_unfilter(raw, h, stride, bpp), w, depth, ch).reshape(h, w, ch)
    dtype = np.uint16 if depth == 16 else np.uint8
    out = np.zeros((h, w, ch), dtype)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * bits + 7) // 8
        n = ph * (stride + 1)
        if pos + n > len(raw):
            raise ImageFormatError("PNG: interlaced image data runs short")
        rows = _unfilter(raw[pos:pos + n], ph, stride, bpp)
        out[y0::dy, x0::dx] = _unpack(rows, pw, depth, ch).reshape(ph, pw, ch)
        pos += n
    if pos != len(raw):
        raise ImageFormatError(f"PNG: {len(raw)} bytes of image data, {pos} expected")
    return out


def _png_rgb(samples: np.ndarray, depth: int, colour: int,
             palette: Optional[bytes]) -> np.ndarray:
    """What PIL's convert("RGB") makes of the samples."""
    if colour == 3:
        if palette is None:
            raise ImageFormatError("PNG: palette image without a PLTE chunk")
        # PIL's palette holds 256 entries, black past the PLTE's
        lut = np.zeros((256, 3), np.uint8)
        pal = np.frombuffer(palette[:768], np.uint8)
        lut.reshape(-1)[:len(pal)] = pal
        return lut[samples[:, :, 0]]
    if depth == 16:
        if colour in (0, 4):
            grey = samples[:, :, 0]
            # mode I;16 (grey) clips to 255 on the way to L; LA;16B keeps
            # the high byte
            grey = np.minimum(grey, 255) if colour == 0 else grey >> 8
            return np.repeat(grey.astype(np.uint8)[:, :, None], 3, axis=2)
        return (samples[:, :, :3] >> 8).astype(np.uint8)
    if colour in (0, 4):
        grey = samples[:, :, 0]
        if depth < 8:
            grey = grey * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(grey[:, :, None], 3, axis=2)
    return samples[:, :, :3]


def _parse_png(data: bytes):
    """(header fields, samples, PLTE, text info dict)."""
    header, idat, palette, info = None, [], None, {}
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"eXIf":
            info["exif"] = b"Exif\x00\x00" + body
        elif kind in (b"tEXt", b"zTXt", b"iTXt"):
            _png_text(kind, body, info)
    if header is None or not idat:
        raise ImageFormatError("PNG: no IHDR or no IDAT")
    w, h, depth, colour, compression, filtering, interlace = header
    if colour not in _DEPTHS or depth not in _DEPTHS[colour]:
        raise ImageFormatError(f"PNG: bit depth {depth} with colour type {colour} is not a "
                               f"valid combination")
    if compression or filtering or interlace > 1 or not w or not h:
        raise ImageFormatError(f"PNG: compression {compression}, filter method {filtering}, "
                               f"interlace {interlace}, size {w}x{h}")
    samples = _png_samples(zlib.decompress(b"".join(idat)), w, h, depth, colour,
                           bool(interlace))
    return (w, h, depth, colour), samples, palette, info


# -------------------------------------------------------------------- JPEG
def _jpeg_segments(data: bytes) -> dict:
    """What PIL's JpegImagePlugin keeps of the APP1 segments before the
    first scan: "exif" (the first "Exif" segment, later ones appended)
    and "xmp" (the last XMP segment's packet)."""
    info: dict = {}
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            break
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xDA, 0xD9):
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and body.startswith(b"Exif\x00\x00"):
            info["exif"] = info["exif"] + body[6:] if "exif" in info else body
        elif marker == 0xE1 and body.startswith(_XMP_JPEG_HEAD):
            info["xmp"] = body.split(b"\x00", 1)[1]
        pos += 2 + length
    return info


def _decode_jpeg(data: bytes) -> np.ndarray:
    lib = _jpeg_library()
    dims = np.zeros(3, np.int32)
    err = ctypes.create_string_buffer(256)
    if lib.cv_jpeg_info(data, len(data), dims.ctypes.data, err, len(err)):
        raise ImageFormatError(err.value.decode())
    w, h, ch = (int(v) for v in dims)
    out = np.empty((h, w, ch), np.uint8)
    if lib.cv_jpeg_decode(data, len(data), out.ctypes.data, err, len(err)):
        raise ImageFormatError(err.value.decode())
    return out


# -------------------------------------------------------------------- EXIF
_TIFF_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8,
               13: 4, 16: 8}
_TIFF_INTS = {3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I", 16: "Q"}


def _tiff_ifd(tiff: bytes, offset: int, order: str) -> dict:
    """One IFD's tags → values as PIL's ImageFileDirectory_v2 gives them
    through Exif: BYTE and UNDEFINED as bytes, ASCII as latin-1 text
    (one trailing NUL dropped), integers as an int or, several, a tuple.
    Rational and floating types are left out (no tag read here uses
    them)."""
    (count,) = struct.unpack(order + "H", tiff[offset:offset + 2])
    out = {}
    for i in range(count):
        entry = tiff[offset + 2 + 12 * i:offset + 14 + 12 * i]
        if len(entry) < 12:
            break
        tag, typ, n, raw = struct.unpack(order + "HHI4s", entry)
        if typ not in _TIFF_SIZES:
            continue
        size = _TIFF_SIZES[typ] * n
        if size > 4:
            (at,) = struct.unpack(order + "I", raw)
            raw = tiff[at:at + size]
            if len(raw) < size:
                continue  # PIL skips a tag whose data runs past the end
        else:
            raw = raw[:size]
        if typ in (1, 7):
            out[tag] = raw
        elif typ == 2:
            out[tag] = (raw[:-1] if raw.endswith(b"\x00") else raw).decode("latin-1", "replace")
        elif typ in _TIFF_INTS:
            vals = struct.unpack(order + _TIFF_INTS[typ] * n, raw)
            out[tag] = vals[0] if n == 1 else vals
    return out


def exif_tags(exif: bytes) -> dict:
    """The tags of TIFF-structured EXIF data (with or without the
    "Exif\\0\\0" prefix) and of its Exif sub-IFD, merged as PIL's
    `getexif()._get_merged_dict()` merges them. Raises ValueError on
    data that is not TIFF."""
    while exif.startswith(b"Exif\x00\x00"):
        exif = exif[6:]
    if not exif:
        return {}
    order = {b"II": "<", b"MM": ">"}.get(exif[:2])
    if order is None or struct.unpack(order + "H", exif[2:4])[0] != 42:
        raise ValueError("EXIF: not a TIFF header")
    try:
        (ifd,) = struct.unpack(order + "I", exif[4:8])
        tags = _tiff_ifd(exif, ifd, order)
        sub = tags.get(EXIF_IFD_TAG)
        if isinstance(sub, int):
            tags.update(_tiff_ifd(exif, sub, order))
    except struct.error:
        raise ValueError("EXIF: truncated IFD") from None
    return tags


def exif_orientation(exif: bytes) -> int:
    """The orientation tag of TIFF-structured EXIF data, 1 when absent or
    unreadable."""
    try:
        value = exif_tags(exif).get(ORIENTATION_TAG, 1)
    except ValueError:
        return 1
    return value if isinstance(value, int) else 1


def _orientation(info: dict) -> int:
    """The orientation `PIL.Image.getexif` reports for an image's info
    dict: the EXIF's tag, else the XMP's tiff:Orientation, else 1. EXIF
    that does not parse gives 1 (the JAX package swallows the error)."""
    exif = info.get("exif")
    if exif is None and _RAW_EXIF in info:
        try:
            exif = bytes.fromhex("".join(info[_RAW_EXIF].split("\n")[3:]))
        except ValueError:
            return 1
    tags = {}
    if exif is not None:
        try:
            tags = exif_tags(exif)
        except ValueError:
            return 1
    if ORIENTATION_TAG in tags:
        value = tags[ORIENTATION_TAG]
        return value if isinstance(value, int) else 1
    xmp = _xmp_orientation(info)
    return 1 if xmp is None else xmp


def _xmp_orientation(info: dict) -> Optional[int]:
    """`tiff:Orientation` of the XMP in an info dict, as getexif reads it
    (the "XML:com.adobe.xmp" text, else the "xmp" bytes), or None."""
    xmp = info.get(_XMP_KEY)
    pattern = _XMP_ORIENTATION
    if not xmp and (xmp := info.get("xmp")):
        pattern = pattern.encode()
    match = re.search(pattern, xmp) if xmp else None
    return int(match[2]) if match else None


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


def _decode(data: bytes) -> tuple[np.ndarray, dict]:
    """(RGB uint8 image before orientation, PIL-style info dict)."""
    if data.startswith(PNG_SIGNATURE):
        (_w, _h, depth, colour), samples, palette, info = _parse_png(data)
        return _png_rgb(samples, depth, colour, palette), info
    if data[:3] == b"\xff\xd8\xff":
        img = _decode_jpeg(data)
        if img.shape[2] == 1:
            img = np.repeat(img, 3, axis=2)
        return img, _jpeg_segments(data)
    raise ImageFormatError(f"not a PNG or JPEG ({_format_name(data)}); BMP, WebP and other "
                           f"formats are not read (ROADMAP Queue A 9)")


def read_png(path: str) -> np.ndarray:
    """An 8-bit grey, RGB or RGBA PNG's samples as stored: (H, W) grey,
    (H, W, 3) RGB or (H, W, 4) RGBA uint8, no orientation applied."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ImageFormatError(f"not a PNG ({_format_name(data)})")
    (_w, _h, depth, colour), samples, _palette, _info = _parse_png(data)
    if depth != 8 or colour not in (0, 2, 6):
        raise ImageFormatError(f"read_png reads 8-bit grey, RGB and RGBA PNGs; this one has "
                               f"colour type {colour} at bit depth {depth}")
    return samples[:, :, 0] if colour == 0 else samples


def decode_image(data: bytes) -> np.ndarray:
    """PNG or JPEG bytes → (H, W, 3) RGB uint8, EXIF-rotated."""
    img, info = _decode(data)
    return np.ascontiguousarray(exif_transpose(img, _orientation(info)))


def load_image(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image(f.read())


def format_exif_value(value):
    """Display form of one EXIF value (reference format_value,
    src/utils.py:558-565): bytes → size note, strings cleaned of
    non-printables ("[Empty string]" when nothing survives)."""
    if isinstance(value, bytes):
        return f"[Binary data, {len(value)} bytes]"
    if isinstance(value, str):
        cleaned = "".join(c for c in value if c.isprintable())
        return cleaned if cleaned else "[Empty string]"
    return value


def format_exif_data(path: str) -> Optional[dict]:
    """Orientation/Software tags for display (src/utils.py:567-596), as
    the JAX function returns them through PIL's `_getexif()`: a JPEG's
    APP1 EXIF, a PNG's eXIf chunk or "Raw profile type exif" text (PIL
    12.1.0 reads those for PNG too), merged with the Exif sub-IFD and,
    where the EXIF has no orientation, the XMP's; None when the file has
    no EXIF, holds neither tag, or fails to parse."""
    try:
        with open(path, "rb") as f:
            data = f.read()
        _img, info = _decode(data)
    except Exception:
        return None
    if "exif" not in info and not (data.startswith(PNG_SIGNATURE) and _RAW_EXIF in info):
        return None
    exif = info.get("exif")
    try:
        if exif is None:
            exif = bytes.fromhex("".join(info[_RAW_EXIF].split("\n")[3:]))
        tags = exif_tags(exif)
    except ValueError:
        return None
    if ORIENTATION_TAG not in tags and (xmp := _xmp_orientation(info)) is not None:
        tags[ORIENTATION_TAG] = xmp
    out = {_DISPLAY_TAGS[t]: format_exif_value(v) for t, v in tags.items() if t in _DISPLAY_TAGS}
    return out or None

