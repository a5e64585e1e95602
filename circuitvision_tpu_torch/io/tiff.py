"""TIFF decoding as Pillow 12.1.0 reads a file's first IFD (its
TiffImagePlugin; libtiff 4.7 for every compressed file), then its
orientation applied as `ImageOps.exif_transpose` applies it, then
convert("RGB").

  * classic TIFF and BigTIFF, either byte order, the first IFD only;
  * photometric 0 and 1 at 1, 2, 4 and 8 bits (WhiteIsZero inverted; 2-
    and 4-bit grey scaled by 85 and 17), grey + alpha; 1- to 8-bit
    palette (ColorMap entries // 256); 8-bit RGB, RGB + unused sample,
    RGBA with unassociated alpha, and with associated (premultiplied)
    alpha, which PIL's "RGBa" unpacker divides out (v · 255 // a); 8-bit
    CMYK (PIL's cmyk2rgb); wider samples in the modes PIL opens them
    in: 16-bit grey ("I;16", either photometric, no inversion), 12-bit
    grey (little-endian files, Pillow's "I;12" unpacker), and 32-bit
    unsigned or 16- and 32-bit signed grey ("I") clamped to 0-255, 32-bit
    float grey ("F") clamped and truncated, 8-bit signed grey read as its
    bytes ("L"), and 16-bit RGB, RGB + unused sample, RGBA (unassociated
    and associated alpha) and CMYK by the high byte of each sample (PIL's
    ";16" unpackers); the fill order 2 where PIL lists it (one
    sample, or 8-bit RGB): the bits of each stored byte reversed, before
    decompression, as libtiff reverses them;
  * contiguous and planar samples, strips and tiles (edge tiles cut);
  * no compression (read by PIL itself, which takes the last offset when
    one strip covers the image, and never applies a predictor), PackBits,
    LZW (native/lzw.cpp) and Deflate (compressions 8 and 32946, Python's
    zlib), the last two with horizontal differencing (predictor 2) on
    8-, 16- and 32-bit integer samples;
  * CCITT compression of bilevel images: modified Huffman (2), T.4 (3,
    1-D or, with T4Options bit 0, 2-D rows) and T.6 (4) through
    native/ccitt.cpp, each strip decoded afresh as libtiff decodes it;
  * JPEG compression (new style, 7): each strip or tile a JPEG stream,
    completed by the JPEGTables, decoded by native/jpeg.cpp as libtiff's
    libjpeg decodes it for PIL (YCbCr converted to RGB, RGB and grey as
    they are);
  * Orientation (tag 274) 2-8 as exif_transpose applies it.

What stays unread raises `ImageFormatError` naming it: old-style JPEG
compression (and any other not above), the floating-
point predictor, YCbCr and CIELab. A file PIL cannot read raises too,
naming the reason (16-bit grey + alpha, 64-bit or half floats, signed or
float colour).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from .ccitt import decode_ccitt
from .lzw import packbits, tiff_lzw

_MAX_PIXELS = 2 * int(1024 * 1024 * 1024 // 4 // 3)
#: field type → (bytes per value, struct code)
_TYPES = {1: (1, "B"), 2: (1, "B"), 3: (2, "H"), 4: (4, "I"), 5: (8, "II"), 6: (1, "b"),
          7: (1, "B"), 8: (2, "h"), 9: (4, "i"), 10: (8, "ii"), 11: (4, "f"), 12: (8, "d"),
          13: (4, "I"), 16: (8, "Q"), 17: (8, "q"), 18: (8, "Q")}
_COMPRESSIONS = {1: "raw", 2: "CCITT modified Huffman", 3: "CCITT G3", 4: "CCITT G4",
                 5: "LZW", 7: "JPEG", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}
_REFUSED = {6: "old-style JPEG", 34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA",
            50000: "Zstandard", 50001: "WebP"}
_T4OPTIONS = 292
_JPEGTABLES = 347
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


def _first_ifd(data: bytes) -> tuple[dict, str]:
    """(tag → tuple of values (bytes for ASCII and UNDEFINED) of the first
    IFD, the byte order "<" or ">")."""
    if data[:2] not in (b"II", b"MM") or len(data) < 8:
        raise _error("not a TIFF file")
    bo = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\x00", b"\x00+")
    if big:  # BigTIFF: 8-byte offsets and counts, 20-byte entries
        if bo == ">":
            raise _error("big-endian BigTIFF is not read (PIL 12.1.0 takes it for a classic "
                         "TIFF and fails)")
        if len(data) < 16:
            raise _error("not a TIFF file")
        (pos,) = struct.unpack_from(bo + "Q", data, 8)
        count_code, entry, inline = "Q", 20, 8
    else:
        (pos,) = struct.unpack_from(bo + "I", data, 4)
        count_code, entry, inline = "H", 12, 4
    head = struct.calcsize(count_code)
    if pos + head > len(data):
        raise _error("the first IFD lies past the end of the file")
    (n,) = struct.unpack_from(bo + count_code, data, pos)
    tags = {}
    for i in range(n):
        at = pos + head + entry * i
        if at + entry > len(data):
            raise _error("truncated IFD")
        tag, kind = struct.unpack_from(bo + "HH", data, at)
        (count,) = struct.unpack_from(bo + ("Q" if big else "I"), data, at + 4)
        if kind not in _TYPES:
            continue
        size, code = _TYPES[kind]
        total = size * count
        value_at = at + (12 if big else 8)
        if total <= inline:
            raw = data[value_at:value_at + total]
        else:
            (off,) = struct.unpack_from(bo + ("Q" if big else "I"), data, value_at)
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
    return tags, bo


def _one(tags: dict, tag: int, default: int) -> int:
    vals = tags.get(tag)
    return int(vals[0]) if vals else default


def _mode(photo: int, bps: tuple, extra: tuple, fmt: int, bo: str) -> str:
    """PIL's mode and raw mode family for the supported keys (its
    TiffImagePlugin.OPEN_INFO)."""
    le = bo == "<"
    if fmt == 2:
        if photo == 1 and bps == (8,) and not extra:
            return "grey"  # "L" from the signed bytes as they are
        if photo == 1 and bps in ((16,), (32,)) and not extra:
            return "I"
        raise _error(f"signed samples with photometric {photo}, bits {bps} and extra samples "
                     f"{extra} are not read")
    if fmt == 3:
        if photo in (0, 1) and bps == (32,) and not extra:
            return "F"
        raise _error(f"floating-point samples with photometric {photo}, bits {bps} and extra "
                     f"samples {extra} are not read")
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
    if bps == (16,) and not extra and (photo == 1 or (photo == 0 and le)):
        return "I;16"
    if bps == (12,) and photo == 1 and not extra and le:
        return "I;16"  # Pillow's "I;12" unpacker
    if bps == (32,) and photo == 1 and not extra and le:
        return "I"
    if photo == 2 and bps == (16, 16, 16) and not extra:
        return "RGB"
    if photo == 2 and bps == (16,) * 4 and extra in ((), (0,), (2,)):
        return "RGB+"
    if photo == 2 and bps == (16,) * 4 and extra == (1,):
        return "RGBa"
    if photo == 5 and bps == (16,) * 4 and not extra:
        return "CMYK"
    what = {6: "YCbCr", 8: "CIELab", 4: "transparency-mask"}.get(photo, f"photometric {photo}")
    if any(b > 8 for b in bps):
        raise _error(f"{max(bps)}-bit samples are not read ({what}, bits {bps})")
    raise _error(f"{what} with bits per sample {bps} and extra samples {extra} is not read")


def _decompress(raw: bytes, scheme: int, size: int, ccitt=None) -> bytes:
    """`size` bytes of a strip or tile; `ccitt` (T4Options, width, rows)
    for compressions 2-4."""
    if scheme == 1:
        return raw[:size]
    try:
        if scheme in (2, 3, 4):
            out = decode_ccitt(raw, scheme, *ccitt)
        elif scheme == 5:
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


def _dtype(bits: int, fmt: int, bo: str) -> np.dtype:
    return np.dtype(bo + {1: "u", 2: "i", 3: "f"}[fmt] + str(bits // 8))


def _samples(rows: np.ndarray, bits: int, n: int, width: int, fmt: int, bo: str) -> np.ndarray:
    """(H, rowbytes) bytes → (H, W, n) samples."""
    h = rows.shape[0]
    if bits < 8 or bits == 12:  # packed, most significant bit first
        v = np.unpackbits(rows, axis=1)[:, :width * n * bits].reshape(h, width * n, bits)
        v = (v.astype(np.uint16) << np.arange(bits - 1, -1, -1, dtype=np.uint16)).sum(-1)
        return v.astype(np.uint8 if bits < 8 else np.uint16).reshape(h, width, n)
    size = bits // 8
    flat = np.ascontiguousarray(rows[:, :width * n * size])
    if size > 1 or fmt != 1:
        flat = flat.view(_dtype(bits, fmt, bo))
    return flat.reshape(h, width, n)


def grey_to_rgb(v: np.ndarray) -> np.ndarray:
    """PIL's convert("RGB") of an I;16 or I image (H, W): through L, which
    clips each value to [0, 255]."""
    grey = np.clip(v, 0, 255).astype(np.uint8)
    return np.repeat(grey[:, :, None], 3, axis=2)


def _rgb(planes: list, mode: str, bps: tuple, photo: int, tags: dict, width: int, fmt: int,
         bo: str):
    """(H, W, 3) uint8 from (H, rowbytes) sample rows, one array for
    contiguous samples or one a sample for planar."""
    from .image_io import cmyk_to_rgb

    if len(planes) > 1:
        samples = np.concatenate([_samples(p, bps[0], 1, width, fmt, bo) for p in planes], -1)
    else:
        samples = _samples(planes[0], bps[0], len(bps), width, fmt, bo)
    if mode in ("I;16", "I", "F"):  # PIL's conversion of these modes to L, then RGB
        v = samples[:, :, 0]
        if mode == "F":
            v = np.nan_to_num(v.astype(np.float64), nan=0.0, posinf=255.0, neginf=0.0)
        elif v.dtype == np.uint32:
            v = v.view(np.int32)  # PIL's "I" is signed
        return grey_to_rgb(v)
    if samples.dtype == np.int8:
        samples = samples.view(np.uint8)
    elif samples.dtype.itemsize == 2:  # PIL's ";16" unpackers keep the high byte
        samples = (samples >> 8).astype(np.uint8)
    if mode in ("bilevel", "grey", "grey+alpha"):
        bits = min(bps[0], 8)
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


def _jpeg_blocks(data: bytes, tags: dict, offsets, counts, size, block, tiled: bool, photo: int,
                 bps: tuple, planar: int) -> np.ndarray:
    """(H, W, 3) uint8 of a JPEG-compressed image: each strip or tile a
    JPEG stream after the JPEGTables' tables."""
    from .image_io import ImageFormatError, _decode_jpeg

    if planar != 1 or not ((photo in (2, 6) and bps == (8, 8, 8)) or (photo == 1 and bps == (8,))):
        raise _error(f"JPEG compression with photometric {photo}, bits {bps} and planar "
                     f"configuration {planar} is not read")
    (width, height), (tw, th) = size, block
    tables = tags.get(_JPEGTABLES, b"")
    tables = tables[:-2] if tables.endswith(b"\xff\xd9") else tables
    across, down = (-(-width // tw) if tiled else 1), -(-height // th)
    out = np.zeros((down * th, across * tw, 3), np.uint8)
    for k in range(across * down):
        ty, tx = divmod(k, across)
        raw = data[int(offsets[k]):int(offsets[k]) + int(counts[k])]
        stream = tables + raw[2:] if tables and raw[:2] == b"\xff\xd8" else raw
        try:
            img = _decode_jpeg(stream)
        except ImageFormatError as exc:
            raise _error(f"JPEG strip or tile {k}: {exc}") from None
        rows = th if tiled else min(th, height - ty * th)
        if img.shape[0] < rows or img.shape[1] < tw:
            raise _error(f"JPEG strip or tile {k} is {img.shape[1]} x {img.shape[0]}, "
                         f"not {tw} x {rows}")
        if img.shape[2] == 1:
            img = np.repeat(img, 3, axis=2)
        out[ty * th:ty * th + rows, tx * tw:(tx + 1) * tw] = img[:rows, :tw, :3]
    return out[:height, :width]


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes → (H, W, 3) uint8 RGB of the first IFD, orientation
    applied."""
    from .image_io import exif_transpose

    tags, bo = _first_ifd(data)
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
    sample_format = tuple(int(f) for f in tags.get(_SAMPLEFORMAT, (1,)))
    if len(set(sample_format)) != 1 or sample_format[0] not in (1, 2, 3):
        raise _error(f"sample format {sample_format} is not read")
    fmt = sample_format[0]
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
    # JPEG strips carry their own colour space (libjpeg converts YCbCr)
    mode = "JPEG" if scheme == 7 else _mode(photo, bps, extra, fmt, bo)
    if scheme in (2, 3, 4) and mode != "bilevel":
        raise _error(f"{_COMPRESSIONS[scheme]} compression of a {mode} image "
                     f"(bits {bps}) is not read")
    if fillorder == 2 and (mode not in ("bilevel", "grey", "RGB", "P", "I;16") or fmt != 1
                           or (bps[0] > 8 and (bo != "<" or photo != 1 or mode == "RGB"))):
        raise _error(f"unknown pixel mode (fill order 2 with bits per sample {bps})")
    if fillorder == 2 and scheme == 1 and ((mode == "P" and bps[0] < 8)
                                           or (mode == "grey" and bps[0] == 8 and photo == 0)):
        # PIL's own raw decoder has no "P;1R", "P;2R", "P;4R" or "L;IR"
        raise _error(f"unknown raw mode for an uncompressed {mode} image in fill order 2")
    predictor = _one(tags, _PREDICTOR, 1) if scheme in (5, 8, 32946) else 1
    if predictor not in (1, 2):
        raise _error(f"predictor {predictor} is not read")
    if predictor == 2 and (bps[0] not in (8, 16, 32) or fmt == 3):
        raise _error(f"horizontal differencing with {bps[0]}-bit samples of format {fmt} "
                     "(libtiff refuses it)")

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
    if scheme == 7:
        rgb = _jpeg_blocks(data, tags, offsets, counts, (width, height), (tw, th), tiled, photo,
                           bps, planar)
        orientation = _one(tags, _ORIENTATION, 1)
        return np.ascontiguousarray(exif_transpose(rgb, orientation if 2 <= orientation <= 8
                                                   else 1))
    if scheme != 1 and len(counts) < len(offsets):
        raise _error("missing strip or tile byte counts")
    if tiled and (tw * sbits) % 8:
        raise _error(f"tiles {tw} pixels of {sbits} bits wide end inside a byte")
    if scheme == 1 and planar == 2 and bps[0] > 8:
        raise _error(f"uncompressed planar {bps[0]}-bit samples are not read (PIL 12.1.0 "
                     "unpacks each band as 8-bit samples)")
    # PIL reads a compressed file through libtiff, which hands it the samples
    # in the host's byte order, and for big-endian signed and float grey
    # ("I;16BS", "I;32BS", "F;32BF") unpacks them as big-endian all the same:
    # each sample byte-swapped, as reading the file's bytes little-endian gives
    sample_bo = "<" if scheme != 1 and bo == ">" and fmt in (2, 3) and bps[0] > 8 else bo
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
                buf = _decompress(raw, scheme, size,
                                  (_one(tags, _T4OPTIONS, 0), tw, rows))
                if len(buf) < size:
                    raise _error(f"image file is truncated ({len(buf)} of {size} bytes)")
                block = np.frombuffer(buf, np.uint8).reshape(rows, rowbytes)
                if predictor == 2:  # in samples of the file's width and byte order
                    step = 1 if planar == 2 else spp
                    dt = _dtype(bps[0], 1, bo)
                    block = np.ascontiguousarray(block).view(dt).reshape(rows, -1, step)
                    block = block.cumsum(axis=1, dtype=dt).astype(dt).view(np.uint8)
                    block = block.reshape(rows, rowbytes)
                full[p, ty * th:ty * th + rows, tx * rowbytes:(tx + 1) * rowbytes] = block
    planes = [full[p, :height] for p in range(nplanes)]
    rgb = _rgb(planes, mode, bps, photo, tags, width, fmt, sample_bo)
    orientation = _one(tags, _ORIENTATION, 1)
    return np.ascontiguousarray(exif_transpose(rgb, orientation if 2 <= orientation <= 8 else 1))
