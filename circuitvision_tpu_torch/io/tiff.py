"""TIFF decoding as Pillow 12.1.0 reads a file's first IFD (its
TiffImagePlugin; libtiff 4.7 for every compressed file), then its
orientation applied as `ImageOps.exif_transpose` applies it, then
convert("RGB").

  * classic TIFF, either byte order, the first IFD only;
  * photometric 0 and 1 at 1, 2, 4 and 8 bits (WhiteIsZero inverted; 2-
    and 4-bit grey scaled by 85 and 17), grey + alpha; 1- to 8-bit
    palette (ColorMap entries // 256); 8-bit RGB, RGB + unused sample,
    RGBA with unassociated alpha, and with associated (premultiplied)
    alpha, which PIL's "RGBa" unpacker divides out (v · 255 // a); 8-bit
    CMYK (PIL's cmyk2rgb); the fill order 2 where PIL lists it (one
    sample, or 8-bit RGB): the bits of each stored byte reversed, before
    decompression, as libtiff reverses them;
  * contiguous and planar samples, strips and tiles (edge tiles cut);
  * no compression (read by PIL itself, which takes the last offset when
    one strip covers the image, and never applies a predictor), PackBits,
    LZW (native/lzw.cpp) and Deflate (compressions 8 and 32946, Python's
    zlib), the last two with horizontal differencing (predictor 2) on
    8-bit samples;
  * Orientation (tag 274) 2-8 as exif_transpose applies it.

What stays unread raises `ImageFormatError` naming it: JPEG, old-JPEG and
CCITT G3/G4 compression (and any other), 16-bit and wider or signed or
float samples, YCbCr and CIELab, BigTIFF. A file PIL cannot read raises
too, naming the reason.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from .lzw import packbits, tiff_lzw

_MAX_PIXELS = 2 * int(1024 * 1024 * 1024 // 4 // 3)
#: field type → (bytes per value, struct code)
_TYPES = {1: (1, "B"), 2: (1, "B"), 3: (2, "H"), 4: (4, "I"), 5: (8, "II"), 6: (1, "b"),
          7: (1, "B"), 8: (2, "h"), 9: (4, "i"), 10: (8, "ii"), 11: (4, "f"), 12: (8, "d"),
          13: (4, "I")}
_COMPRESSIONS = {1: "raw", 5: "LZW", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}
_REFUSED = {2: "CCITT modified Huffman", 3: "CCITT G3", 4: "CCITT G4", 6: "old-style JPEG",
            7: "JPEG", 34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA", 50000: "Zstandard",
            50001: "WebP"}
#: tags
(_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC, _FILLORDER, _STRIPOFFSETS,
 _ORIENTATION, _SAMPLES, _ROWSPERSTRIP, _STRIPBYTES, _PLANAR, _PREDICTOR, _COLORMAP,
 _TILEWIDTH, _TILELENGTH, _TILEOFFSETS, _TILEBYTES, _EXTRA, _SAMPLEFORMAT) = (
    256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320, 322, 323, 324,
    325, 338, 339)
_BIT_REVERSE = np.asarray([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _error(msg: str) -> Exception:
    from .image_io import ImageFormatError
    return ImageFormatError(f"TIFF: {msg}")


def _first_ifd(data: bytes) -> dict:
    """tag → tuple of values (bytes for ASCII and UNDEFINED) of the first
    IFD."""
    if data[:4] in (b"II+\x00", b"MM\x00+"):
        raise _error("BigTIFF is not read")
    if data[:2] not in (b"II", b"MM") or len(data) < 8:
        raise _error("not a TIFF file")
    bo = "<" if data[:2] == b"II" else ">"
    (pos,) = struct.unpack_from(bo + "I", data, 4)
    if pos + 2 > len(data):
        raise _error("the first IFD lies past the end of the file")
    (n,) = struct.unpack_from(bo + "H", data, pos)
    tags = {}
    for i in range(n):
        at = pos + 2 + 12 * i
        if at + 12 > len(data):
            raise _error("truncated IFD")
        tag, kind, count = struct.unpack_from(bo + "HHI", data, at)
        if kind not in _TYPES:
            continue
        size, code = _TYPES[kind]
        total = size * count
        if total <= 4:
            raw = data[at + 8:at + 8 + total]
        else:
            (off,) = struct.unpack_from(bo + "I", data, at + 8)
            raw = data[off:off + total]
            if len(raw) < total:
                continue  # PIL skips a value past the end of the file
        if kind in (2, 7):
            tags[tag] = raw
        else:
            vals = struct.unpack(bo + code * count, raw)
            if kind in (5, 10):
                vals = tuple(vals[i] / vals[i + 1] if vals[i + 1] else float("nan")
                             for i in range(0, len(vals), 2))
            tags[tag] = vals
    return tags


def _one(tags: dict, tag: int, default: int) -> int:
    vals = tags.get(tag)
    return int(vals[0]) if vals else default


def _mode(photo: int, bps: tuple, extra: tuple) -> str:
    """PIL's mode and raw mode family for the supported keys."""
    if bps == (1,) and photo in (0, 1):
        return "bilevel"
    if photo in (0, 1) and bps in ((2,), (4,), (8,)):
        return "grey"
    if photo == 1 and bps == (8, 8) and extra == (2,):
        return "grey+alpha"
    if photo == 2 and bps == (8, 8, 8) and not extra:
        return "RGB"
    if photo == 2 and bps == (8, 8, 8, 8) and extra in ((), (0,), (2,), (999,)):
        return "RGB+"
    if photo == 2 and bps == (8, 8, 8, 8) and extra == (1,):
        return "RGBa"
    if photo == 3 and bps in ((1,), (2,), (4,), (8,)):
        return "P"
    if photo == 3 and bps == (8, 8) and extra in ((0,), (2,)):
        return "P+"
    if photo == 5 and bps == (8, 8, 8, 8) and not extra:
        return "CMYK"
    what = {6: "YCbCr", 8: "CIELab", 4: "transparency-mask"}.get(photo, f"photometric {photo}")
    if any(b > 8 for b in bps):
        raise _error(f"{max(bps)}-bit samples are not read ({what}, bits {bps})")
    raise _error(f"{what} with bits per sample {bps} and extra samples {extra} is not read")


def _decompress(raw: bytes, scheme: int, size: int) -> bytes:
    if scheme == 1:
        return raw[:size]
    try:
        if scheme == 5:
            out = tiff_lzw(raw, size)
        elif scheme == 32773:
            out = packbits(raw, size)
        else:
            out = zlib.decompressobj().decompress(raw, size)
    except (ValueError, zlib.error) as exc:
        raise _error(f"{_COMPRESSIONS[scheme]}: {exc}") from None
    if len(out) < size:
        raise _error(f"{_COMPRESSIONS[scheme]}: not enough data ({len(out)} of {size} bytes)")
    return out


def _rgb(planes: list, mode: str, bps: tuple, photo: int, tags: dict, width: int):
    """(H, W, 3) uint8 from (H, rowbytes) sample rows, one array for
    contiguous samples or one a sample for planar."""
    from .image_io import cmyk_to_rgb

    if len(planes) > 1:
        samples = np.stack([p[:, :width] for p in planes], axis=-1)
    else:
        rows = planes[0]
        bits = bps[0]
        if bits < 8:
            h = rows.shape[0]
            v = np.unpackbits(rows, axis=1).reshape(h, -1, bits)[:, :width]
            v = (v * (1 << np.arange(bits - 1, -1, -1))).sum(-1).astype(np.uint8)
            samples = v[:, :, None]
        else:
            n = len(bps)
            samples = rows[:, :width * n].reshape(rows.shape[0], width, n)
    if mode in ("bilevel", "grey", "grey+alpha"):
        bits = bps[0]
        grey = samples[:, :, 0].astype(np.int32) * (255 // ((1 << bits) - 1))
        if photo == 0:
            grey = 255 - grey
        return np.repeat(grey.astype(np.uint8)[:, :, None], 3, axis=2)
    if mode in ("P", "P+"):
        cmap = tags.get(_COLORMAP)
        n = 1 << bps[0]
        if cmap is None or len(cmap) < 3 * n:
            raise _error("a palette image without a full ColorMap")
        lut = (np.asarray(cmap[:3 * n], np.int64) // 256).astype(np.uint8).reshape(3, n).T
        return lut[samples[:, :, 0]]
    if mode == "CMYK":
        return cmyk_to_rgb(255 - samples[:, :, :4])
    rgb = samples[:, :, :3]
    if mode == "RGBa":
        a = samples[:, :, 3:4].astype(np.int32)
        un = np.minimum(rgb.astype(np.int32) * 255 // np.maximum(a, 1), 255)
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb, un)).astype(np.uint8)
    return rgb


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes → (H, W, 3) uint8 RGB of the first IFD, orientation
    applied."""
    from .image_io import exif_transpose

    tags = _first_ifd(data)
    if 0xBC01 in tags:
        raise _error("Windows Media Photo files are not read")
    scheme = _one(tags, _COMPRESSION, 1)
    if scheme in _REFUSED:
        raise _error(f"{_REFUSED[scheme]} compression ({scheme}) is not read")
    if scheme not in _COMPRESSIONS:
        raise _error(f"compression {scheme} is not read")
    if _WIDTH not in tags or _LENGTH not in tags:
        raise _error("missing dimensions")
    width, height = _one(tags, _WIDTH, 0), _one(tags, _LENGTH, 0)
    if width * height > _MAX_PIXELS:
        raise _error(f"{width} x {height} pixels is over PIL's decompression-bomb limit")
    photo = _one(tags, _PHOTOMETRIC, 0)
    planar = _one(tags, _PLANAR, 1)
    fillorder = _one(tags, _FILLORDER, 1)
    sample_format = tuple(tags.get(_SAMPLEFORMAT, (1,)))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    if sample_format != (1,):
        raise _error(f"sample format {sample_format} (signed or floating point) is not read")
    bps = tuple(int(b) for b in tags.get(_BITS, (1,)))
    extra = tuple(int(e) for e in tags.get(_EXTRA, ()))
    spp = _one(tags, _SAMPLES, 1)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise _error("unknown data organization (bits per sample against samples per pixel)")
    if fillorder not in (1, 2):
        raise _error(f"unknown pixel mode (fill order {fillorder})")
    mode = _mode(photo, bps, extra)
    if fillorder == 2 and mode not in ("bilevel", "grey", "RGB", "P"):
        raise _error(f"unknown pixel mode (fill order 2 with bits per sample {bps})")
    if fillorder == 2 and scheme == 1 and ((mode == "P" and bps[0] < 8)
                                           or (mode == "grey" and bps[0] == 8 and photo == 0)):
        # PIL's own raw decoder has no "P;1R", "P;2R", "P;4R" or "L;IR"
        raise _error(f"unknown raw mode for an uncompressed {mode} image in fill order 2")
    predictor = _one(tags, _PREDICTOR, 1) if scheme in (5, 8, 32946) else 1
    if predictor not in (1, 2):
        raise _error(f"predictor {predictor} is not read")
    if predictor == 2 and bps[0] != 8:
        raise _error(f"horizontal differencing with {bps[0]}-bit samples (libtiff refuses it)")

    tiled = _TILEOFFSETS in tags
    if tiled:
        tw, th = _one(tags, _TILEWIDTH, 0), _one(tags, _TILELENGTH, 0)
        if tw <= 0 or th <= 0:
            raise _error("invalid tile dimensions")
        offsets, counts = tags[_TILEOFFSETS], tags.get(_TILEBYTES, ())
    elif _STRIPOFFSETS in tags:
        tw, th = width, min(_one(tags, _ROWSPERSTRIP, height) or height, height)
        offsets, counts = tags[_STRIPOFFSETS], tags.get(_STRIPBYTES, ())
    else:
        raise _error("unknown data organization (no strip or tile offsets)")
    nplanes = spp if planar == 2 else 1
    sbits = bps[0] if planar == 2 else sum(bps)
    rowbytes = (tw * sbits + 7) // 8
    across = -(-width // tw) if tiled else 1
    down = -(-height // th)
    if len(offsets) < nplanes * across * down:
        raise _error(f"{len(offsets)} offsets for {nplanes * across * down} strips or tiles")
    if scheme != 1 and len(counts) < len(offsets):
        raise _error("missing strip or tile byte counts")
    if tiled and (tw * sbits) % 8:
        raise _error(f"tiles {tw} pixels of {sbits} bits wide end inside a byte")
    if scheme == 1 and not tiled and _one(tags, _ROWSPERSTRIP, height) == height \
            and planar != 2:
        offsets = offsets[-1:]  # one strip covers the image: PIL reads the last offset
    full = np.zeros((nplanes, down * th, across * rowbytes), np.uint8)
    k = 0
    for p in range(nplanes):
        for ty in range(down):
            for tx in range(across):
                rows = th if tiled else min(th, height - ty * th)
                size = rows * rowbytes
                off = int(offsets[k])
                raw = data[off:off + (size if scheme == 1 else int(counts[k]))]
                k += 1
                if fillorder == 2:
                    raw = _BIT_REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
                buf = _decompress(raw, scheme, size)
                if len(buf) < size:
                    raise _error(f"image file is truncated ({len(buf)} of {size} bytes)")
                block = np.frombuffer(buf, np.uint8).reshape(rows, rowbytes)
                if predictor == 2:
                    step = 1 if planar == 2 else spp
                    block = block.reshape(rows, -1, step).cumsum(axis=1, dtype=np.uint8)
                    block = block.reshape(rows, rowbytes)
                full[p, ty * th:ty * th + rows, tx * rowbytes:(tx + 1) * rowbytes] = block
    planes = [full[p, :height] for p in range(nplanes)]
    rgb = _rgb(planes, mode, bps, photo, tags, width)
    orientation = _one(tags, _ORIENTATION, 1)
    return np.ascontiguousarray(exif_transpose(rgb, orientation if 2 <= orientation <= 8 else 1))
