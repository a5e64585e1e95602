"""JPEG 2000 uploads as PIL 12.1.0 reads them (Jpeg2KImagePlugin over
OpenJPEG 2.5.4), without PIL.

A JP2 file (the signature box, `ftyp`, `jp2h` with `ihdr`, `colr`,
`bpcc`, `pclr`, `cmap`, `cdef`, `res `, then `jp2c`) or a raw codestream
(`.j2k`, `.j2c`, `.jpc`: FF4F FF51). native/j2k.cpp decodes the
codestream into each component's samples; this module takes PIL's view
of them:

  * the mode as the plugin's header parse gives it: from `ihdr` (1
    component L, or I;16 above 8 bits per `ihdr`'s depth; 2 LA; 3 RGB; 4
    RGBA, or CMYK where a `colr` box names enumerated space 12), or from
    SIZ for a raw codestream (I;16 above 8 bits); P and PA from a `pclr`
    box of depths up to 8 on L and LA, its palette built as
    ImagePalette.getcolor builds it (a repeated colour keeps its first
    index, later entries shift down);
  * the colour space OpenJPEG reports from the first `colr` box
    (enumerated 16 sRGB, 17 grey, 18 sYCC, 24 e-sYCC, 12 CMYK; any other,
    an ICC profile or none: unspecified, which Pillow reads as grey for 1
    or 2 components and sRGB for 3 or 4), and Pillow's decoder's
    unpacker for (mode, colour space, components) — a pair it has none
    for raises, as PIL does. `pclr`, `cmap` and `cdef` are never applied:
    Pillow decodes by tiles, and OpenJPEG applies them only to whole
    images;
  * each sample as the unpacker makes it: OpenJPEG's value cut to its
    storage (one byte up to 8 bits, two up to 16), plus 2^(prec − 1) for
    signed samples and, above the target depth, half its last unit, then
    shifted to 8 bits (16 for I;16); sYCC through Pillow's
    ImagingConvertYCbCr2RGB (tables of (int)(c·(i − 128)·64 + 0.5), a
    6-bit shift, clipped).

`decode_jpeg2000` gives what the JAX package's decode_image gives for
such a file: PIL's convert("RGB") of that image (I;16 clipped to 255 as
PIL's I;16 → L does, CMYK through cmyk2rgb, P and PA through the palette,
an index past it black). PIL finds no EXIF in a JPEG 2000 file, so
nothing is rotated. What native/j2k.cpp refuses raises ImageFormatError
naming it; so does a truncated or corrupt file, where PIL raises too, and
an image over PIL's decompression-bomb limit, by its header's size before
anything is decoded.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path

import numpy as np

from ..core.native import build_library

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"
_NATIVE = Path(__file__).resolve().parent / "native"
#: OpenJPEG's colour spaces for `colr` enumerations (opj_jp2_read_header)
_ENUMCS = {16: "srgb", 17: "gray", 18: "sycc", 24: "eycc", 12: "cmyk"}
#: PIL's decompression-bomb limit (2 · Image.MAX_IMAGE_PIXELS), as io/tiff.py
_MAX_PIXELS = 2 * int(1024 * 1024 * 1024 // 4 // 3)
#: Pillow's unpackers (Jpeg2KDecode.c) by (mode, colour space, components)
_UNPACKERS = {
    ("L", "gray", 1): "gray", ("I;16", "gray", 1): "gray_i", ("LA", "gray", 2): "gray_a",
    ("P", "srgb", 1): "gray", ("PA", "srgb", 2): "gray_a",
    ("RGB", "srgb", 3): "rgb", ("RGB", "sycc", 3): "sycc",
    ("RGBA", "srgb", 4): "rgba", ("RGBA", "gray", 4): "rgba", ("RGBA", "sycc", 4): "sycca",
    ("CMYK", "cmyk", 4): "rgba",
}


def _error(msg: str):
    from .image_io import ImageFormatError

    return ImageFormatError(f"JPEG 2000: {msg}")


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = build_library(_NATIVE / "j2k.cpp", "cvj2k")
    for name in ("cv_j2k_header", "cv_j2k_decode"):
        getattr(lib, name).restype = ctypes.c_int
    lib.cv_j2k_header.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.cv_j2k_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
    lib.cv_j2k_packets.restype = ctypes.c_int64
    lib.cv_j2k_packets.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
    return lib


def _boxes(data: bytes, start: int, end: int):
    """(type, body start, body end) of the boxes in data[start:end]."""
    pos = start
    while pos + 8 <= end:
        lbox, tbox = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if lbox == 1:
            if pos + 16 > end:
                raise _error("truncated box header")
            lbox = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            head = 16
        elif lbox == 0:
            lbox = end - pos
        if lbox < head or pos + lbox > end:
            raise _error("invalid box length")
        yield tbox, pos + head, pos + lbox
        pos += lbox


def _getcolor_palette(entries: list) -> list:
    """The palette ImagePalette.getcolor builds from the entries in order:
    a colour already present keeps its index; more than 256 raises."""
    palette: list = []
    for c in entries:
        if c not in palette:
            if len(palette) >= 256:
                raise _error("cannot allocate more than 256 colors")
            palette.append(c)
    return palette


def _jp2_header(data: bytes):
    """(mode, colour space, palette or None, codestream) of a JP2 file, as
    PIL's _parse_jp2_header and OpenJPEG's box reader find them."""
    jp2h = jp2c = None
    for tbox, b0, b1 in _boxes(data, 12, len(data)):
        if tbox == b"jp2h" and jp2h is None:
            jp2h = (b0, b1)
        elif tbox == b"jp2c" and jp2c is None:
            jp2c = data[b0:b1]
    if jp2h is None:
        raise _error("no jp2h box")
    if jp2c is None:
        raise _error("no jp2c (codestream) box")
    mode = nc = size = None
    space = None
    palette = None
    for tbox, b0, b1 in _boxes(data, *jp2h):
        body = data[b0:b1]
        if tbox == b"ihdr":
            if len(body) < 11:
                raise _error("ihdr too short")
            h, w, nc, bpc = struct.unpack(">IIHB", body[:11])
            size = (w, h)
            mode = ({1: "I;16" if (bpc & 0x7F) > 8 else "L", 2: "LA", 3: "RGB", 4: "RGBA"}
                    .get(nc))
        elif tbox == b"colr" and len(body) >= 3:
            meth = body[0]
            enumcs = struct.unpack(">I", body[3:7])[0] if meth == 1 and len(body) >= 7 else None
            if space is None:  # OpenJPEG takes the first colr box
                space = _ENUMCS.get(enumcs, "unspecified")
            if nc == 4 and meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = struct.unpack(">HB", body[:3])
            depths = body[3:3 + npc]
            if len(depths) < npc:
                raise _error("pclr too short")
            if max(depths, default=0) <= 8:
                raw = body[3 + npc:3 + npc + ne * npc]
                if len(raw) < ne * npc:
                    raise _error("pclr too short")
                palette = (_getcolor_palette([tuple(raw[i * npc:(i + 1) * npc])
                                              for i in range(ne)]), npc)
                mode = "P" if mode == "L" else "PA"
    if mode is None:
        raise _error("malformed JP2 header")
    return mode, space or "unspecified", palette, jp2c, size


def _ycbcr_tables():
    i = np.arange(256, dtype=np.float64) - 128

    def table(c):  # C's (int)(x + 0.5): toward zero
        return np.trunc(c * i * 64 + 0.5).astype(np.int64)
    return table(1.402), table(-0.34414), table(-0.71414), table(1.772)


_R_CR, _G_CB, _G_CR, _B_CB = _ycbcr_tables()


def ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """Pillow's ImagingConvertYCbCr2RGB on (…, 3) uint8."""
    y, cb, cr = (ycc[..., k].astype(np.int64) for k in range(3))
    out = np.stack([y + (_R_CR[cr] >> 6), y + ((_G_CB[cb] + _G_CR[cr]) >> 6),
                    y + (_B_CB[cb] >> 6)], -1)
    return np.clip(out, 0, 255).astype(np.uint8)


def _unpack(plane: np.ndarray, prec: int, sgnd: int, bits: int) -> np.ndarray:
    """One component as Pillow's unpackers store it: the value as OpenJPEG
    stores it (1, 2 or 4 bytes), plus the signed offset and the rounding
    half, shifted to `bits` (8, or 16 for I;16) and cut to them."""
    csiz = (prec + 7) >> 3
    u = plane.astype(np.int64) & ((1 << (8 * (4 if csiz == 3 else csiz))) - 1)
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    v = u + offset
    v = v << shift if shift >= 0 else v >> -shift
    return (v & ((1 << bits) - 1)).astype(np.uint16 if bits == 16 else np.uint8)


def _check_size(w: int, h: int) -> None:
    """PIL's DecompressionBombError, raised by Image.open on the size the
    plugin read, before anything is decoded."""
    if w * h > _MAX_PIXELS:
        raise _error(f"{w} x {h} pixels is over PIL's decompression-bomb limit")


def codestream_header(cs: bytes) -> tuple[int, int, list]:
    """(width, height, [(precision, signed)] per component) from SIZ; an
    image over PIL's decompression-bomb limit raises."""
    info = np.zeros(6 + 2 * 16384, np.int64)
    msg = ctypes.create_string_buffer(512)
    if _library().cv_j2k_header(cs, len(cs), info.ctypes.data, len(info), msg, len(msg)):
        raise _error(msg.value.decode(errors="replace"))
    w, h, nc = int(info[0]), int(info[1]), int(info[4])
    _check_size(w, h)
    return w, h, [(int(info[6 + 2 * c]), int(info[7 + 2 * c])) for c in range(nc)]


def decode_codestream(cs: bytes) -> tuple[np.ndarray, list]:
    """((components, H, W) int32 samples as OpenJPEG gives them — DC level
    shift applied, clamped to each component's range — and each
    component's (precision, signed))."""
    w, h, comps = codestream_header(cs)
    out = np.empty((len(comps), h, w), np.int32)
    msg = ctypes.create_string_buffer(512)
    if _library().cv_j2k_decode(cs, len(cs), out.ctypes.data, out.size, msg, len(msg)):
        raise _error(msg.value.decode(errors="replace"))
    return out, comps


def packet_spans(cs: bytes) -> np.ndarray:
    """(packets, 5) int64: tile, header start and end, body start and end
    of every packet, as offsets in the codestream (−1 for headers held in
    PPM/PPT), in the order the packets come."""
    lib = _library()
    msg = ctypes.create_string_buffer(512)
    cap = 5 << 16
    while True:
        out = np.empty(cap, np.int64)
        n = lib.cv_j2k_packets(cs, len(cs), out.ctypes.data, cap, msg, len(msg))
        if n < 0:
            raise _error(msg.value.decode(errors="replace"))
        if 5 * n <= cap:
            return out[:5 * n].reshape(n, 5)
        cap = 5 * n


def read_jpeg2000(data: bytes):
    """(mode, samples, palette) as PIL gives them: `np.asarray(Image.open(
    ...))` (H, W) or (H, W, bands) — uint16 for I;16, uint8 otherwise —
    its mode, and for P/PA the palette as ((colour tuples), bands)."""
    if data.startswith(J2K_SIGNATURE):
        cs = data
        _w, _h, comps = codestream_header(cs)
        nc = len(comps)
        if nc not in (1, 2, 3, 4):
            raise _error("unable to determine J2K image mode")
        mode = {1: "I;16" if comps[0][0] > 8 else "L", 2: "LA", 3: "RGB", 4: "RGBA"}[nc]
        space, palette = "unspecified", None
    elif data.startswith(JP2_SIGNATURE):
        mode, space, palette, cs, size = _jp2_header(data)
        _check_size(*size)
        w, h, comps = codestream_header(cs)
        if (w, h) != size:
            raise _error(f"ihdr says {size[0]}x{size[1]}, the codestream {w}x{h}")
    else:
        raise _error("not a JPEG 2000 file")
    # the unpacker before the samples, so no more than 4 planes are made
    nc = len(comps)
    if space == "unspecified":
        space = "gray" if nc <= 2 else "srgb"
    kind = _UNPACKERS.get((mode, space, nc))
    if kind is None:
        raise _error(f"PIL's decoder has no unpacker for mode {mode} with {nc} components in "
                     f"colour space {space}")
    planes, comps = decode_codestream(cs)
    bits = 16 if kind == "gray_i" else 8
    bands = [_unpack(planes[c], *comps[c], bits) for c in range(nc)]
    if kind in ("gray", "gray_i"):
        samples = bands[0]
    elif kind == "gray_a":
        samples = np.stack([bands[0], bands[1]], -1)
    else:
        samples = np.stack(bands, -1)
        if kind in ("sycc", "sycca"):
            samples[..., :3] = ycbcr_to_rgb(samples[..., :3])
    return mode, samples, palette


def to_rgb(mode: str, samples: np.ndarray, palette) -> np.ndarray:
    """PIL's convert("RGB") of read_jpeg2000's image."""
    from .image_io import cmyk_to_rgb
    from .tiff import grey_to_rgb

    if mode == "I;16":
        return grey_to_rgb(samples)
    if mode in ("L", "LA"):
        grey = samples if mode == "L" else samples[..., 0]
        return np.repeat(grey[..., None], 3, axis=2)
    if mode in ("P", "PA"):
        colours, _bands = palette
        table = np.zeros((256, 3), np.uint8)
        for i, c in enumerate(colours):
            table[i] = c[:3]
        index = samples if mode == "P" else samples[..., 0]
        return table[index]
    if mode == "CMYK":  # PIL's cmyk2rgb on the stored (not inverted) samples
        return cmyk_to_rgb(255 - samples)
    return np.ascontiguousarray(samples[..., :3])


def decode_jpeg2000(data: bytes) -> np.ndarray:
    """JP2 or J2K bytes → (H, W, 3) RGB uint8, PIL's convert("RGB")."""
    return to_rgb(*read_jpeg2000(data))
