#!/usr/bin/env python3
"""Write the image-input fixtures of the PyTorch port: JPEG, PNG, BMP and
WebP files of the kinds its reader (circuitvision_tpu_torch/io/
image_io.py) takes, and the SHA-256 of what PIL makes of each.

    python scripts/make_image_fixtures.py [--seed 0] [--out eval_data/image_fixtures]

Needs PIL and cv2, and g++ with the system's jpeglib.h (libjpeg-turbo
built with arithmetic coding) and webp/encode.h, against which it builds
scripts/image_fixture_writer.cpp into a temporary directory (this script
only; the port reads the files without any of them). From the eval images
(eval_data/images, sorted) and a seeded generator it writes:

  * eval/<name>.jpg — JPEG versions of the first 16 eval images
    (baseline, 4:2:0, quality 85), the web UI's uploads on the card;
  * JPEGs of one eval image in every kind the reader takes: baseline
    4:2:0, 4:2:2, 4:4:0 (cv2's writer) and 4:4:4, progressive (PIL's
    scan script), greyscale (baseline and progressive), restart
    intervals (baseline and progressive), EXIF orientations 3, 6 and 8,
    an orientation held only in XMP, an Adobe-RGB file (transform 0),
    and a photo-sized one (2048 × 1536, a drawing under uneven light and
    sensor noise);
  * progressive_unrefined.jpg — PIL's progressive file with its
    refinement scans removed, which libjpeg decodes through block
    smoothing;
  * PNG variants: palette with and without tRNS, grey+alpha, grey at
    bit depths 1, 2, 4 and 16, 16-bit RGB, Adam7 interlacing, EXIF in a
    "Raw profile type exif" text chunk, orientation only in XMP;
  * the JPEG kinds PIL reads beyond those: a CMYK file (PIL's, Adobe
    inverted), YCCK, arithmetic coding sequential (SOF9, with restarts)
    and progressive (SOF10), 4:2:0 at 4 x 2 (the writer), 4:1:1 (cv2),
    and lossless SOF3 written here (predictor 7 with a point transform,
    and predictor 4 in grey);
  * eval/<name>.webp — lossless WebP versions of the first 16 eval
    images, which the card runs analyze-batch over beside the PNGs;
  * WebP (PIL): lossless, lossy (eval drawing and photo), lossy with
    alpha, lossless with alpha, EXIF orientation 6 (an odd-length
    chunk), XMP orientation 8; a two-frame animation built here whose
    first frame sits at an offset on a larger canvas; and (the writer)
    lossy files with the simple loop filter, sharpness, 4 and 8 token
    partitions;
  * BMP: PIL's 1-bit, grey, palette, RGB and RGBA files, and written
    here: OS/2 (12-byte header), 4-bit, top-down 24-bit, BI_BITFIELDS
    5-6-5 and 32-bit with a V5 header, RLE8 and RLE4;
  * JPEG 2000 (PIL's encoder, and rewrites of its boxes and markers):
    see jpeg2000_kinds;
  * digests.json — per file PIL reads: the shape and SHA-256 of
    `np.asarray(ImageOps.exif_transpose(Image.open(f)).convert("RGB"))`
    (the JAX package's decode_image).
"""
from __future__ import annotations

import argparse
import hashlib
import io
import json
import struct
import subprocess
import tempfile
import zlib
from pathlib import Path

import cv2
import numpy as np
from PIL import Image, ImageOps

REPO = Path(__file__).resolve().parents[1]
EVAL = REPO / "eval_data" / "images"


def pil_rgb(data: bytes) -> np.ndarray:
    """The JAX package's decode_image: PIL, exif_transpose, RGB."""
    img = Image.open(io.BytesIO(data))
    exif = img.getexif()
    if exif and exif.get(0x0112, 1) != 1:
        img = ImageOps.exif_transpose(img)
    return np.asarray(img.convert("RGB"))


def digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def jpeg_pil(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def jpeg_cv2(img: np.ndarray, *params) -> bytes:
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]), list(params))
    assert ok
    return enc.tobytes()


def exif_blob(orientation: int, software: str = "CircuitVision fixtures") -> bytes:
    """Little-endian TIFF: IFD0 with Orientation (SHORT) and Software
    (ASCII)."""
    sw = software.encode() + b"\x00"
    ifd = struct.pack("<H", 2)
    ifd += struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
    ifd += struct.pack("<HHII", 0x0131, 2, len(sw), 8 + 2 + 24 + 4)
    return b"II*\x00" + struct.pack("<I", 8) + ifd + struct.pack("<I", 0) + sw


def xmp_packet(orientation: int) -> bytes:
    return (b'<?xpacket begin="" id="W5M0MpCehiHzreSzNTczkc9d"?><x:xmpmeta xmlns:x="adobe:ns:meta/">'
            b'<rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#"><rdf:Description '
            b'xmlns:tiff="http://ns.adobe.com/tiff/1.0/" tiff:Orientation="%d"/></rdf:RDF>'
            b"</x:xmpmeta><?xpacket end=\"w\"?>" % orientation)


def jpeg_with_app1(jpeg: bytes, body: bytes) -> bytes:
    """An APP1 segment inserted right after SOI."""
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + jpeg[2:]


def strip_refinement_scans(jpeg: bytes) -> bytes:
    """A progressive JPEG without its refinement scans (Ah > 0): each
    scan is its SOS segment and the entropy-coded bytes up to the next
    marker, so dropping whole scans leaves a valid file whose
    coefficients stay at the precision of their first scans."""
    out, pos = bytearray(jpeg[:2]), 2
    while pos < len(jpeg):
        marker = jpeg[pos + 1]
        if marker == 0xD9:
            out += jpeg[pos:pos + 2]
            break
        (length,) = struct.unpack(">H", jpeg[pos + 2:pos + 4])
        end = pos + 2 + length
        if marker == 0xDA:
            ns = jpeg[pos + 4]
            ahal = jpeg[pos + 4 + 1 + 2 * ns + 2]
            scan_end = end
            while not (jpeg[scan_end] == 0xFF and jpeg[scan_end + 1] not in (0x00,)
                       and not 0xD0 <= jpeg[scan_end + 1] <= 0xD7):
                scan_end += 1
            if ahal >> 4 == 0:
                out += jpeg[pos:scan_end]
            pos = scan_end
            continue
        out += jpeg[pos:end]
        pos = end
    return bytes(out)


# ---------------------------------------------------------------- PNG writer
def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack_rows(samples: np.ndarray, depth: int) -> list[bytes]:
    """(h, n) samples → packed rows at `depth` bits."""
    if depth == 16:
        return [r.astype(">u2").tobytes() for r in samples]
    if depth == 8:
        return [r.astype(np.uint8).tobytes() for r in samples]
    rows = []
    for r in samples:
        bits = np.unpackbits(r.astype(np.uint8)[:, None], axis=1)[:, 8 - depth:].reshape(-1)
        rows.append(np.packbits(bits).tobytes())
    return rows


def png_bytes(samples: np.ndarray, depth: int, colour: int, interlace: bool = False,
              plte: bytes | None = None, trns: bytes | None = None, extra: bytes = b"",
              filters=(0, 1, 2, 3, 4)) -> bytes:
    """A PNG of (h, w, channels) samples, written with every row filter in
    turn (PNG specification 9.2) and, where asked, Adam7 passes."""
    h, w, ch = samples.shape
    bpp = max(1, depth * ch // 8)
    raw = bytearray()
    passes = (((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
               (1, 0, 2, 2), (0, 1, 1, 2)) if interlace else ((0, 0, 1, 1),))
    row_no = 0
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prev = None
        for r in _pack_rows(sub.reshape(sub.shape[0], -1), depth):
            cur = np.frombuffer(r, np.uint8).astype(np.int32)
            up = prev if prev is not None else np.zeros_like(cur)
            ftype = filters[row_no % len(filters)]
            row_no += 1
            out = np.empty_like(cur)
            for i in range(len(cur)):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                c = up[i - bpp] if i >= bpp else 0
                if ftype == 0:
                    pred = 0
                elif ftype == 1:
                    pred = a
                elif ftype == 2:
                    pred = b
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                out[i] = (cur[i] - pred) & 255
            raw += bytes([ftype]) + out.astype(np.uint8).tobytes()
            prev = cur
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, int(interlace)))
    if plte is not None:
        body += _chunk(b"PLTE", plte)
    if trns is not None:
        body += _chunk(b"tRNS", trns)
    return (b"\x89PNG\r\n\x1a\n" + body + extra + _chunk(b"IDAT", zlib.compress(bytes(raw), 9))
            + _chunk(b"IEND", b""))


def itxt(key: bytes, text: bytes) -> bytes:
    return _chunk(b"iTXt", key + b"\x00\x00\x00\x00\x00" + text)


def raw_profile_exif(exif: bytes) -> bytes:
    """EXIF as ImageMagick writes it: a tEXt "Raw profile type exif" of
    hex lines after a three-line header."""
    hexed = exif.hex()
    lines = "\n".join(hexed[i:i + 72] for i in range(0, len(hexed), 72))
    text = f"\nexif\n{len(exif):8d}\n{lines}\n".encode()
    return _chunk(b"tEXt", b"Raw profile type exif\x00" + text)


# ------------------------------------------------------------------- files
def photo(rng: np.random.Generator, drawing: np.ndarray) -> np.ndarray:
    """A 2048 × 1536 'photo' of a drawing: the drawing scaled up on a
    sheet under uneven warm light, with sensor noise."""
    h, w = 1536, 2048
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    light = 0.78 + 0.2 * np.exp(-(((xx - 0.6 * w) / (0.9 * w)) ** 2
                                   + ((yy - 0.4 * h) / (0.8 * h)) ** 2))
    sheet = cv2.resize(drawing, (int(w * 0.8), int(h * 0.8)), interpolation=cv2.INTER_CUBIC)
    canvas = np.full((h, w, 3), 235.0, np.float32)
    y0, x0 = (h - sheet.shape[0]) // 2, (w - sheet.shape[1]) // 2
    canvas[y0:y0 + sheet.shape[0], x0:x0 + sheet.shape[1]] = sheet
    canvas *= light[:, :, None] * np.array([1.0, 0.96, 0.88], np.float32)
    canvas += rng.normal(0.0, 2.0, canvas.shape).astype(np.float32)
    return np.clip(np.round(canvas), 0, 255).astype(np.uint8)


# ------------------------------------------------- the JPEG and WebP writer
class Writer:
    """scripts/image_fixture_writer.cpp, built with g++ at first use."""

    def __init__(self):
        self._tmp = tempfile.TemporaryDirectory()
        self.exe = Path(self._tmp.name) / "writer"
        subprocess.run(["g++", "-O2", str(REPO / "scripts" / "image_fixture_writer.cpp"), "-o",
                        str(self.exe), "-ljpeg", "-lwebp"], check=True)

    def _run(self, args, pixels: np.ndarray) -> bytes:
        return subprocess.run([str(self.exe), *map(str, args)],
                              input=np.ascontiguousarray(pixels).tobytes(),
                              capture_output=True, check=True).stdout

    def jpeg(self, img, space="ycc", quality=90, arith=0, progressive=0, restart=0,
             factors=()) -> bytes:
        h, w, c = img.shape
        return self._run(["jpeg", w, h, c, space, quality, arith, progressive, restart,
                          *factors], img)

    def webp(self, img, quality=75, method=4, filter_type=1, sharpness=0, strength=60,
             segments=4, partitions=0, sns=50, alpha_filtering=1) -> bytes:
        h, w, c = img.shape
        return self._run(["webp", w, h, c, quality, method, filter_type, sharpness, strength,
                          segments, partitions, sns, alpha_filtering], img)


# ------------------------------------------------------------ lossless JPEG
def _bit_writer():
    """(put(value, nbits), flush() -> bytes) with JPEG's 0xFF stuffing."""
    out, acc = bytearray(), [0, 0]

    def put(v, n):
        for i in range(n - 1, -1, -1):
            acc[0], acc[1] = (acc[0] << 1) | ((v >> i) & 1), acc[1] + 1
            if acc[1] == 8:
                out.append(acc[0])
                if acc[0] == 0xFF:
                    out.append(0)
                acc[:] = [0, 0]

    def flush():
        if acc[1]:
            put((1 << (8 - acc[1])) - 1, 8 - acc[1])
        return bytes(out)

    return put, flush


def _lossless_differences(x: np.ndarray, predictor: int, pt: int, first_rows) -> np.ndarray:
    """ITU T.81 H.1.2.1: each point-transformed sample minus its prediction
    (Ra left, Rb above, Rc above-left; the first row of a scan or restart
    interval predicts from the left, its first sample 2^(7-Pt); the first
    column from above), modulo 2^16."""
    x = x.astype(np.int64) >> pt
    h, w = x.shape
    pred = np.zeros_like(x)
    for y in range(h):
        for c in range(w):
            if y in first_rows:
                pred[y, c] = (1 << (7 - pt)) if c == 0 else x[y, c - 1]
            elif c == 0:
                pred[y, c] = x[y - 1, c]
            else:
                ra, rb, rc = x[y, c - 1], x[y - 1, c], x[y - 1, c - 1]
                pred[y, c] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                              6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
    return (x - pred) & 0xFFFF


def lossless_jpeg(samples: np.ndarray, predictor: int = 1, pt: int = 0,
                  restart_rows: int = 0) -> bytes:
    """A lossless (SOF3) JPEG of (h, w, components) uint8 samples, one
    interleaved scan, sampling factors 1, component ids 1.. (libjpeg-turbo
    reads them as RGB in lossless mode), one Huffman table giving every
    difference category 0-16 a 5-bit code."""
    h, w, nc = samples.shape
    first = set(range(0, h, restart_rows)) if restart_rows else {0}
    diffs = [_lossless_differences(samples[:, :, c], predictor, pt, first) for c in range(nc)]
    put, flush = _bit_writer()
    segments = []
    for y in range(h):
        if restart_rows and y and y % restart_rows == 0:
            segments.append(flush())
            put, flush = _bit_writer()
        for x in range(w):
            for c in range(nc):
                d = int(diffs[c][y, x])
                if d == 32768:
                    put(16, 5)
                    continue
                d = d - 65536 if d > 32768 else d
                s = abs(d).bit_length()
                put(s, 5)
                if s:
                    put(d if d > 0 else d - 1 + (1 << s), s)
    segments.append(flush())
    counts = bytes(4) + bytes([17]) + bytes(11)
    out = b"\xff\xd8\xff\xc4" + struct.pack(">H", 2 + 1 + 16 + 17) + b"\x00" + counts + bytes(range(17))
    sof = bytes([8]) + struct.pack(">HH", h, w) + bytes([nc]) + b"".join(
        bytes([c + 1, 0x11, 0]) for c in range(nc))
    out += b"\xff\xc3" + struct.pack(">H", 2 + len(sof)) + sof
    if restart_rows:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart_rows * w)
    sos = bytes([nc]) + b"".join(bytes([c + 1, 0]) for c in range(nc)) + bytes([predictor, 0, pt])
    out += b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
    for i, seg in enumerate(segments):
        out += (bytes([0xFF, 0xD0 + (i - 1) % 8]) if i else b"") + seg
    return out + b"\xff\xd9"


def lossless_jpeg_sampled(planes: list, factors: list, predictor: int = 1, pt: int = 0) -> bytes:
    """A lossless (SOF3) JPEG of subsampled components, one interleaved
    scan: `planes[i]` is component i at its own size, ceil(W·h_i / h_max)
    by ceil(H·v_i / v_max) for the image's W × H (planes[0] at h_max,
    v_max), `factors[i]` its (h, v). Each plane is padded by replicating
    its last column and row to the MCUs' extent, as the MCUs cover it."""
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    h0, w0 = planes[0].shape
    width, height = w0 * hmax // factors[0][0], h0 * vmax // factors[0][1]
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    diffs = []
    for plane, (fh, fv) in zip(planes, factors):
        lw, lh = mcux * fh, mcuy * fv
        padded = np.pad(plane, ((0, lh - plane.shape[0]), (0, lw - plane.shape[1])), mode="edge")
        diffs.append(_lossless_differences(padded, predictor, pt, {0}))
    put, flush = _bit_writer()
    for uy in range(mcuy):
        for ux in range(mcux):
            for d, (fh, fv) in zip(diffs, factors):
                for by in range(fv):
                    for bx in range(fh):
                        v = int(d[uy * fv + by, ux * fh + bx])
                        if v == 32768:
                            put(16, 5)
                            continue
                        v = v - 65536 if v > 32768 else v
                        size = abs(v).bit_length()
                        put(size, 5)
                        if size:
                            put(v if v > 0 else v - 1 + (1 << size), size)
    counts = bytes(4) + bytes([17]) + bytes(11)
    out = b"\xff\xd8\xff\xc4" + struct.pack(">H", 2 + 1 + 16 + 17) + b"\x00" + counts + bytes(range(17))
    nc = len(planes)
    sof = bytes([8]) + struct.pack(">HH", height, width) + bytes([nc]) + b"".join(
        bytes([c + 1, (fh << 4) | fv, 0]) for c, (fh, fv) in enumerate(factors))
    out += b"\xff\xc3" + struct.pack(">H", 2 + len(sof)) + sof
    sos = bytes([nc]) + b"".join(bytes([c + 1, 0]) for c in range(nc)) + bytes([predictor, 0, pt])
    out += b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
    return out + flush() + b"\xff\xd9"


# --------------------------------------------------------------------- BMP
def bmp_bytes(w: int, h: int, bits: int, rows: list, palette: bytes = b"", compression: int = 0,
              header: int = 40, masks: bytes = b"", top_down: bool = False) -> bytes:
    """A BMP of pixel rows as stored (bottom row first unless top_down),
    with a BITMAPINFOHEADER (40), an OS/2 1.x header (12) or a V5 header
    (124; masks inside it), BI_BITFIELDS masks after a 40-byte header."""
    data = b"".join(rows)
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(data), 2835, 2835, len(palette) // 4, 0)
        if header > 40:
            info += (masks + bytes(header - 40))[:header - 40]
    extra = masks if header == 40 and compression == 3 else b""
    offset = 14 + len(info) + len(extra) + len(palette)
    return (b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset) + info + extra
            + palette + data)


def bmp_rows(samples: np.ndarray, bits: int) -> list:
    """Rows of (h, w) indices or (h, w·bytes) bytes, packed at `bits` and
    padded to 4 bytes, top row first."""
    out = []
    for r in samples:
        if bits < 8:
            packed = np.packbits(np.unpackbits(r.astype(np.uint8)[:, None], axis=1)[:, 8 - bits:])
            raw = packed.tobytes()
        else:
            raw = r.astype(np.uint8).tobytes()
        out.append(raw + bytes(-len(raw) % 4))
    return out


def rle_bytes(idx: np.ndarray, rle4: bool) -> bytes:
    """RLE8 or RLE4 of (h, w) indices, bottom row first: runs of equal
    pixels (RLE4: of an alternating pair), absolute runs elsewhere, a
    delta escape over a blank stretch, end of line and end of bitmap."""
    out = bytearray()
    h, w = idx.shape
    for y in range(h - 1, -1, -1):
        row, x = idx[y], 0
        while x < w:
            n = 1
            while x + n < w and n < 255 and row[x + n] == row[x]:
                n += 1
            if n >= 3 or w - x < 3:
                out += bytes([n, (row[x] << 4 | row[x]) if rle4 else row[x]])
                x += n
                continue
            n = min(w - x, 40)
            if rle4:
                n -= n % 2  # PIL reads n // 2 bytes of an absolute run: keep runs even
                if n < 4:
                    out += bytes([1, row[x] << 4])
                    x += 1
                    continue
                vals = row[x:x + n]
                out += bytes([0, n]) + bytes((vals[0::2] << 4) | vals[1::2])
            else:
                out += bytes([0, n]) + bytes(row[x:x + n])
            if len(out) % 2:
                out.append(0)
            x += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


# -------------------------------------------------------------------- WebP
def _riff_chunks(data: bytes) -> list:
    out, pos = [], 12
    while pos < len(data):
        kind, (size,) = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])
        out.append((kind, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _riff_chunk(kind: bytes, body: bytes) -> bytes:
    return kind + struct.pack("<I", len(body)) + body + (b"\x00" if len(body) % 2 else b"")


def webp_pil(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def webp_animation(first: np.ndarray, second: np.ndarray, canvas: tuple, at: tuple,
                   lossless_first: bool = False) -> bytes:
    """VP8X + ANIM + two ANMF frames: the first frame (lossy unless
    lossless_first) at offset `at` on a (w, h) canvas, the second (the
    other kind) at (0, 0)."""
    w, h = canvas
    vp8x = bytes([0x12, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")

    def anmf(img, xy, frame_chunks, flags):
        fh, fw = img.shape[:2]
        head = ((xy[0] // 2).to_bytes(3, "little") + (xy[1] // 2).to_bytes(3, "little")
                + (fw - 1).to_bytes(3, "little") + (fh - 1).to_bytes(3, "little")
                + (100).to_bytes(3, "little") + bytes([flags]))
        return _riff_chunk(b"ANMF", head + b"".join(_riff_chunk(k, p) for k, p in frame_chunks))

    one = [c for c in _riff_chunks(webp_pil(first, quality=70, lossless=lossless_first))
           if c[0] != b"VP8X"]
    two = [c for c in _riff_chunks(webp_pil(second, quality=70, lossless=not lossless_first))
           if c[0] != b"VP8X"]
    body = (_riff_chunk(b"VP8X", vp8x) + _riff_chunk(b"ANIM", bytes(6)) + anmf(first, at, one, 0)
            + anmf(second, (0, 0), two, 2))
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


# ------------------------------------------- GIF, TIFF, PNM, ICO, CUR, TGA
def gif_lzw_plain(idx, min_bits: int) -> bytes:
    """GIF LZW of indices with a clear code before the table would widen
    the codes: every code a literal, min_bits + 1 bits wide."""
    clear = 1 << min_bits
    per = clear - 2
    codes = []
    for i in range(0, len(idx), per):
        codes.append(clear)
        codes += [int(v) for v in idx[i:i + per]]
    codes.append(clear + 1)
    acc = nbits = 0
    out = bytearray()
    for c in codes:
        acc |= c << nbits
        nbits += min_bits + 1
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _gif_table(palette: bytes) -> tuple[int, bytes]:
    """(size field, table padded to a power of two entries)."""
    k = max(1, (len(palette) // 3 - 1).bit_length()) - 1
    return k, palette + bytes((3 << (k + 1)) - len(palette))


def gif_bytes(width: int, height: int, frame: tuple, idx: np.ndarray, gpal: bytes = None,
              lpal: bytes = None, transparency: int = None, interlace: bool = False,
              min_bits: int = 8, version: bytes = b"GIF89a", comment: bytes = b"") -> bytes:
    """A one-frame GIF: `frame` (x, y, w, h) on a width × height screen,
    (h, w) indices stored in row order (interlaced: in the four passes'
    order), plain LZW in 255-byte sub-blocks."""
    out = bytearray(version + struct.pack("<HH", width, height))
    if gpal is not None:
        k, table = _gif_table(gpal)
        out += bytes([0x80 | k, 0, 0]) + table
    else:
        out += bytes(3)
    if comment:
        out += b"\x21\xfe" + bytes([len(comment)]) + comment + b"\x00"
    if transparency is not None:
        out += b"\x21\xf9\x04" + bytes([1, 0, 0, transparency, 0])
    x, y, w, h = frame
    rows = np.arange(h)
    if interlace:
        rows = np.concatenate([np.arange(a, h, b) for a, b in ((0, 8), (4, 8), (2, 4), (1, 2))])
    flags, table = (0x40 if interlace else 0), b""
    if lpal is not None:
        k, table = _gif_table(lpal)
        flags |= 0x80 | k
    out += b"\x2c" + struct.pack("<HHHHB", x, y, w, h, flags) + table + bytes([min_bits])
    data = gif_lzw_plain(np.asarray(idx)[rows].reshape(-1), min_bits)
    for i in range(0, len(data), 255):
        out += bytes([len(data[i:i + 255])]) + data[i:i + 255]
    return bytes(out) + b"\x00;"


def packbits_encode(raw: bytes) -> bytes:
    """PackBits: runs of 3 or more equal bytes as repeats, the rest as
    literals of up to 128 bytes."""
    out, i, n = bytearray(), 0, len(raw)
    while i < n:
        j = i
        while j + 1 < n and raw[j + 1] == raw[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([(1 - (j - i + 1)) & 255, raw[i]])
            i = j + 1
            continue
        start = i
        while i < n and i - start < 128 and not (i + 2 < n and raw[i] == raw[i + 1] == raw[i + 2]):
            i += 1
        out += bytes([i - start - 1]) + raw[start:i]
    return bytes(out)


def tiff_lzw_encode(raw: bytes) -> bytes:
    """TIFF LZW (MSB first, codes 9-12 bits widened one code early, as
    libtiff writes them), a clear code at the start and when the table
    fills."""
    out, acc, nbits = bytearray(), [0], [0]
    width = [9]

    def put(code):
        acc[0] = (acc[0] << width[0]) | code
        nbits[0] += width[0]
        while nbits[0] >= 8:
            out.append((acc[0] >> (nbits[0] - 8)) & 255)
            nbits[0] -= 8
        acc[0] &= (1 << nbits[0]) - 1

    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    put(256)
    w = b""
    for byte in raw:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt >= 1 << width[0] and width[0] < 12:  # the decoder widens a code later
            width[0] += 1
        if nxt >= 4093:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, width[0] = 258, 9
        w = bytes([byte])
    if w:
        put(table[w])
    put(257)
    if nbits[0]:
        out.append((acc[0] << (8 - nbits[0])) & 255)
    return bytes(out)


def tiff_bytes(samples: np.ndarray, bits: int = 8, photometric: int = 2, compression: int = 1,
               predictor: int = 1, planar: int = 1, tile: tuple = None, rows_per_strip: int = None,
               orientation: int = None, extra: tuple = (), colormap: np.ndarray = None,
               big_endian: bool = False, fill_order: int = 1, sample_format: int = 1,
               bigtiff: bool = False, chunks: list = None, more: dict = None) -> bytes:
    """A one-IFD TIFF (or BigTIFF) of (h, w, samples) values, each below
    2**bits (or signed, or float, by `sample_format` 2 or 3), strips of
    `rows_per_strip` rows or `tile` (tw, th) tiles, compressed with 1
    (none), 5 (LZW), 8 or 32946 (Deflate) or 32773 (PackBits) — or the
    strips or tiles given as `chunks`, with `more` entries (tag: (type,
    values), type 7 a bytes value)."""
    bo = ">" if big_endian else "<"
    h, w, spp = samples.shape
    planes = [samples[:, :, i:i + 1] for i in range(spp)] if planar == 2 else [samples]
    tw, th = tile if tile else (w, rows_per_strip or h)
    wide = np.dtype(bo + {1: "u", 2: "i", 3: "f"}[sample_format] + str(max(bits, 8) // 8))
    given, chunks = chunks, []
    for plane in planes if given is None else []:
        n = plane.shape[2]
        for ty in range(0, h, th):
            for tx in range(0, w, tw):
                block = plane[ty:ty + th, tx:tx + tw]
                if tile:  # tiles are whole: pad with zeros
                    block = np.pad(block, ((0, th - block.shape[0]), (0, tw - block.shape[1]),
                                           (0, 0)))
                block = (block.astype(np.uint8) if bits <= 8 else
                         block.astype(np.int64) if bits == 12 else block.astype(wide))
                if predictor == 2:  # differences of the samples' words, modulo their width
                    d = block.view(np.uint8 if bits <= 8 else bo + f"u{bits // 8}").astype(np.int64)
                    d[:, 1:] -= d[:, :-1].copy()
                    block = (d & ((1 << max(bits, 8)) - 1)).astype(
                        np.uint8 if bits <= 8 else bo + f"u{bits // 8}")
                rows_ = block.reshape(block.shape[0], -1)
                if bits < 8 or bits == 12:  # packed, most significant bit first
                    shifts = np.arange(bits - 1, -1, -1)
                    rows_ = np.packbits(((rows_[:, :, None] >> shifts) & 1).astype(np.uint8)
                                        .reshape(rows_.shape[0], -1), axis=1)
                raw = rows_.tobytes()
                if compression == 5:
                    raw = tiff_lzw_encode(raw)
                elif compression in (8, 32946):
                    raw = zlib.compress(raw, 6)
                elif compression == 32773:
                    raw = packbits_encode(raw)
                if fill_order == 2:  # the stored bytes, least significant bit first
                    raw = bytes(int(f"{b:08b}"[::-1], 2) for b in raw)
                chunks.append(raw)
    chunks = given if given is not None else chunks
    offset_kind = 16 if bigtiff else 4
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if orientation:
        entries[274] = (3, [orientation])
    if extra:
        entries[338] = (3, list(extra))
    if sample_format != 1:
        entries[339] = (3, [sample_format] * spp)
    if colormap is not None:
        entries[320] = (3, [int(v) for v in colormap.T.reshape(-1)])
    entries.update(more or {})
    header = 16 if bigtiff else 8
    data = bytearray()
    offsets = []
    for c in chunks:
        offsets.append(header + len(data))
        data += c + (b"\x00" if len(c) % 2 else b"")
    if tile:
        entries.update({322: (3, [tw]), 323: (3, [th]), 324: (offset_kind, offsets),
                        325: (4, [len(c) for c in chunks])})
    else:
        entries.update({273: (offset_kind, offsets), 278: (4, [th]),
                        279: (4, [len(c) for c in chunks])})
    ifd_at = header + len(data)
    count, entry, inline, off = ("Q", 20, 8, "Q") if bigtiff else ("H", 12, 4, "I")
    ifd = struct.pack(bo + count, len(entries))
    values = bytearray()
    values_at = ifd_at + struct.calcsize(count) + entry * len(entries) + inline
    for tag in sorted(entries):
        kind, vals = entries[tag]
        if kind == 7:
            packed = bytes(vals)
        else:
            packed = struct.pack(bo + {3: "H", 4: "I", 16: "Q"}[kind] * len(vals), *vals)
        head = struct.pack(bo + "HH" + off, tag, kind, len(vals))
        if len(packed) <= inline:
            ifd += head + packed.ljust(inline, b"\x00")
        else:
            ifd += head + struct.pack(bo + off, values_at + len(values))
            values += packed + (b"\x00" if len(packed) % 2 else b"")
    ifd += struct.pack(bo + off, 0)
    if bigtiff:
        magic = (b"MM\x00+" if big_endian else b"II+\x00") + struct.pack(bo + "HHQ", 8, 0, ifd_at)
    else:
        magic = (b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(bo + "I", ifd_at)
    return magic + bytes(data) + ifd + bytes(values)


def pnm_bytes(kind: str, samples: np.ndarray, maxval: int = 255, comment: bytes = b"") -> bytes:
    """P1-P6 of (h, w) or (h, w, 3) values; a comment line in the header
    and, for the plain kinds, inside the data."""
    h, w = samples.shape[:2]
    head = f"{kind}\n".encode() + (b"# " + comment + b"\n" if comment else b"") + f"{w} {h}\n".encode()
    if kind not in ("P1", "P4"):
        head += f"{maxval}\n".encode()
    flat = samples.reshape(h, -1)
    if kind == "P1":
        body = b"\n".join(b"".join(b"1" if v else b"0" for v in row) for row in flat)
        return head + body[:len(body) // 2] + b"# " + comment + b"\n" + body[len(body) // 2:]
    if kind in ("P2", "P3"):
        lines = [b" ".join(str(int(v)).encode() for v in row) for row in flat]
        return head + b"\n".join(lines[:1] + [b"# " + comment] + lines[1:]) + b"\n"
    if kind == "P4":
        return head + np.packbits(flat.astype(bool), axis=1).tobytes()
    return head + flat.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def dib_bytes(idx: np.ndarray, bits: int, palette: bytes, mask: np.ndarray = None) -> bytes:
    """An icon's DIB: BITMAPINFOHEADER with twice the height, the palette,
    the pixel rows bottom-up, then the 1-bit AND mask rows (32-bit
    aligned). `idx` is (h, w) indices, or (h, w, 4) BGRA at 32 bits."""
    h, w = idx.shape[:2]
    if bits == 32:
        rows = bmp_rows(np.ascontiguousarray(idx).reshape(h, -1), 32)
    else:
        rows = bmp_rows(idx, bits)
    mask = np.zeros((h, w), bool) if mask is None else mask
    mstride = -(-w // 32) * 4
    mrows = [np.packbits(m).tobytes().ljust(mstride, b"\x00") for m in mask]
    head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0,
                       len(palette) // 4 if bits <= 8 else 0, 0)
    return head + palette + b"".join(rows[::-1]) + b"".join(mrows[::-1])


def icon_bytes(images: list, kind: int = 1, hotspots: list = None) -> bytes:
    """An ICO (kind 1) or CUR (kind 2) of (w, h, bits, colours, data)
    entries in the given order."""
    out = struct.pack("<HHH", 0, kind, len(images))
    at = 6 + 16 * len(images)
    body = b""
    for i, (w, h, bits, colours, data) in enumerate(images):
        planes, bpp = (1, bits) if kind == 1 else (hotspots or [(0, 0)] * len(images))[i]
        out += struct.pack("<BBBBHHII", w & 255, h & 255, colours, 0, planes, bpp, len(data),
                           at + len(body))
        body += data
    return out + body


def tga_rle(px: np.ndarray) -> bytes:
    """TGA RLE of (n, bytes) pixels of one row: repeats of equal pixels,
    else raw packets, each of up to 128 (PIL refuses a packet that runs
    past its row)."""
    out, i, n = bytearray(), 0, len(px)
    rows = [bytes(p) for p in px]
    while i < n:
        j = i
        while j + 1 < n and rows[j + 1] == rows[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([0x80 | (j - i)]) + rows[i]
            i = j + 1
            continue
        start = i
        while i < n and i - start < 128 and not (i + 1 < n and rows[i] == rows[i + 1]):
            i += 1
        out += bytes([i - start - 1]) + b"".join(rows[start:i])
    return bytes(out)


def tga_bytes(px: np.ndarray, kind: int, depth: int, cmap: bytes = b"", cmap_start: int = 0,
              cmap_depth: int = 24, top: bool = False, right: bool = False,
              ident: bytes = b"") -> bytes:
    """A TGA of (h, w, bytes) stored pixel bytes (BGR order, as written),
    rows bottom-up unless `top`, mirrored if `right`."""
    h, w = px.shape[:2]
    rows = px[::-1] if not top else px
    rows = rows[:, ::-1] if right else rows
    flat = np.ascontiguousarray(rows).reshape(h * w, -1)
    ncmap = len(cmap) // (cmap_depth // 8) if cmap else 0
    head = struct.pack("<BBBHHBHHHHBB", len(ident), 1 if cmap else 0, kind, cmap_start, ncmap,
                       cmap_depth if cmap else 0, 0, 0, w, h, depth,
                       (0x20 if top else 0) | (0x10 if right else 0))
    body = b"".join(tga_rle(r) for r in flat.reshape(h, w, -1)) if kind & 8 else flat.tobytes()
    return head + ident + cmap + body


def make(seed: int) -> dict[str, bytes]:
    rng = np.random.default_rng(seed)
    names = sorted(p.stem for p in EVAL.glob("*.png"))
    files: dict[str, bytes] = {}
    for name in names[:16]:
        img = np.asarray(Image.open(EVAL / f"{name}.png").convert("RGB"))
        files[f"eval/{name}.jpg"] = jpeg_pil(img, quality=85)
    base = np.asarray(Image.open(EVAL / f"{names[0]}.png").convert("RGB"))
    # an odd-sized crop so every sampling has partial MCUs at both edges
    img = np.ascontiguousarray(base[3:3 + 301, 5:5 + 403])
    files["baseline_420.jpg"] = jpeg_pil(img, quality=90, subsampling=2)
    files["baseline_422.jpg"] = jpeg_pil(img, quality=90, subsampling=1)
    files["baseline_444.jpg"] = jpeg_pil(img, quality=90, subsampling=0)
    files["baseline_440.jpg"] = jpeg_cv2(img, cv2.IMWRITE_JPEG_QUALITY, 90,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)
    files["progressive.jpg"] = jpeg_pil(img, quality=90, progressive=True)
    files["progressive_unrefined.jpg"] = strip_refinement_scans(files["progressive.jpg"])
    grey = np.asarray(Image.fromarray(img).convert("L"))
    files["grey.jpg"] = jpeg_pil(grey, quality=90)
    files["grey_progressive.jpg"] = jpeg_pil(grey, quality=90, progressive=True)
    files["restart.jpg"] = jpeg_cv2(img, cv2.IMWRITE_JPEG_QUALITY, 90,
                                    cv2.IMWRITE_JPEG_RST_INTERVAL, 5)
    files["restart_progressive.jpg"] = jpeg_cv2(img, cv2.IMWRITE_JPEG_QUALITY, 90,
                                                cv2.IMWRITE_JPEG_RST_INTERVAL, 3,
                                                cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    for o in (3, 6, 8):
        files[f"exif_{o}.jpg"] = jpeg_pil(img, quality=90, exif=exif_blob(o))
    files["xmp_6.jpg"] = jpeg_with_app1(jpeg_pil(img, quality=90),
                                        b"http://ns.adobe.com/xap/1.0/\x00" + xmp_packet(6))
    files["adobe_rgb.jpg"] = jpeg_pil(img, quality=90, keep_rgb=True)
    files["photo.jpg"] = jpeg_pil(photo(rng, base), quality=85)

    small = np.ascontiguousarray(base[::3, ::3][:83, :117])
    idx = rng.integers(0, 16, small.shape[:2] + (1,))
    palette = rng.integers(0, 256, 48, dtype=np.uint8).tobytes()
    files["palette.png"] = png_bytes(idx, 4, 3, plte=palette)
    files["palette_trns.png"] = png_bytes(idx, 8, 3, plte=palette, trns=bytes(range(0, 160, 10)))
    g = np.asarray(Image.fromarray(small).convert("L"))[:, :, None]
    alpha = rng.integers(0, 256, g.shape, dtype=np.uint8)
    files["grey_alpha.png"] = png_bytes(np.concatenate([g, alpha], axis=2), 8, 4)
    for depth in (1, 2, 4):
        files[f"grey_{depth}bit.png"] = png_bytes(g >> (8 - depth), depth, 0)
    files["grey_16bit.png"] = png_bytes(g.astype(np.uint16) * 257 // 300 + (g > 200) * 300,
                                        16, 0)
    files["rgb_16bit.png"] = png_bytes(small.astype(np.uint16) * 257
                                       + rng.integers(0, 256, small.shape), 16, 2)
    files["adam7.png"] = png_bytes(small, 8, 2, interlace=True)
    files["raw_exif_6.png"] = png_bytes(small, 8, 2, extra=raw_profile_exif(exif_blob(6)))
    files["xmp_8.png"] = png_bytes(small, 8, 2, extra=itxt(b"XML:com.adobe.xmp", xmp_packet(8)))
    files.update(more_jpeg(rng, img))
    files.update(webps(rng, names, base, img, small, pil_rgb(files["photo.jpg"])))
    files.update(bmps(rng, small))
    files.update(upload_kinds(rng, names, small, img))
    files.update(queue_19a_kinds(rng, names, small))
    files.update(jpeg2000_kinds(rng, names, small))
    return files


def more_jpeg(rng: np.random.Generator, img: np.ndarray) -> dict[str, bytes]:
    """The JPEG kinds the reader took on after PNG and baseline JPEG."""
    writer = Writer()
    files = {}
    h, w = img.shape[:2]
    k = np.broadcast_to((np.arange(w) * 96 // w).astype(np.uint8), (h, w))[:, :, None]
    cmyk = np.concatenate([255 - img, k], axis=2)
    buf = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", quality=90)
    files["cmyk_adobe.jpg"] = buf.getvalue()
    files["ycck.jpg"] = writer.jpeg(cmyk, space="ycck", factors=(2, 2, 1, 1, 1, 1, 2, 2))
    files["arith.jpg"] = writer.jpeg(img, arith=1, restart=7)
    files["arith_progressive.jpg"] = writer.jpeg(img, arith=1, progressive=1)
    files["sampling_42.jpg"] = writer.jpeg(img, factors=(4, 2, 1, 1, 1, 1))
    files["sampling_411.jpg"] = jpeg_cv2(img, cv2.IMWRITE_JPEG_QUALITY, 90,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)
    files["lossless.jpg"] = lossless_jpeg(img[:64, :96], predictor=7, pt=1, restart_rows=16)
    grey = np.asarray(Image.fromarray(img[:48, :80]).convert("L"))[:, :, None]
    files["lossless_grey.jpg"] = lossless_jpeg(grey, predictor=4)
    return files


def webps(rng: np.random.Generator, names: list, base: np.ndarray, img: np.ndarray,
          small: np.ndarray, photo_rgb: np.ndarray) -> dict[str, bytes]:
    writer = Writer()
    files = {}
    for name in names[:16]:
        drawing = np.asarray(Image.open(EVAL / f"{name}.png").convert("RGB"))
        files[f"eval/{name}.webp"] = webp_pil(drawing, lossless=True)
    files["eval_lossy.webp"] = webp_pil(base, quality=80)
    files["photo.webp"] = webp_pil(photo_rgb, quality=80)  # photo.jpg's pixels
    files["lossless.webp"] = webp_pil(img, lossless=True)
    files["lossy.webp"] = webp_pil(img, quality=75)
    alpha = rng.integers(0, 256, small.shape[:2] + (1,), dtype=np.uint8)
    rgba = np.concatenate([small, alpha], axis=2)
    files["lossy_alpha.webp"] = webp_pil(rgba, quality=75)
    files["lossless_alpha.webp"] = webp_pil(rgba, lossless=True, exact=True)
    exif = exif_blob(6)  # 61 bytes: an odd-length chunk, padded
    files["exif_6.webp"] = webp_pil(small, quality=80, exif=exif)
    files["xmp_8.webp"] = webp_pil(small, lossless=True, xmp=xmp_packet(8))
    files["animation.webp"] = webp_animation(rgba[:40, :60], small[:50, :70], (90, 70), (20, 12))
    # a drawing over a colour ramp with noise, so that every block codes something
    ramp = np.linspace(0, 120, small.shape[1])[None, :, None] * np.array([1.0, 0.5, -0.5])
    noisy = small.astype(np.float64) * 0.6 + ramp + rng.normal(0, 10, small.shape) + 40
    textured = np.clip(np.round(noisy), 0, 255).astype(np.uint8)
    files["simple_filter.webp"] = writer.webp(textured, filter_type=0, sharpness=3, strength=80)
    files["partitions.webp"] = writer.webp(textured, segments=2, partitions=2, sharpness=6)
    files["partitions_8.webp"] = writer.webp(np.ascontiguousarray(np.tile(textured, (2, 2, 1))),
                                             partitions=3, quality=60)
    return files


def bmps(rng: np.random.Generator, small: np.ndarray) -> dict[str, bytes]:
    files = {}
    for mode, name in (("1", "bmp_1bit"), ("L", "bmp_grey"), ("P", "bmp_palette"),
                       ("RGB", "bmp_rgb"), ("RGBA", "bmp_rgba")):
        im = Image.fromarray(small)
        im = im.quantize(16) if mode == "P" else im.convert(mode)
        buf = io.BytesIO()
        im.save(buf, "BMP")
        files[f"{name}.bmp"] = buf.getvalue()
    h, w = small.shape[:2]
    idx = rng.integers(0, 16, (h, w), dtype=np.uint8)
    idx[:, w // 3:2 * w // 3] = idx[:, w // 3:w // 3 + 1]  # runs for RLE
    pal16 = rng.integers(0, 256, 16 * 4, dtype=np.uint8).tobytes()
    pal256 = rng.integers(0, 256, 256 * 4, dtype=np.uint8).tobytes()
    files["bmp_4bit.bmp"] = bmp_bytes(w, h, 4, bmp_rows(idx, 4)[::-1], pal16)
    files["bmp_os2.bmp"] = bmp_bytes(w, h, 8, bmp_rows(idx * 9, 8)[::-1],
                                     bytes(b for i, b in enumerate(pal256) if i % 4 != 3),
                                     header=12)
    bgr = np.ascontiguousarray(small[:, :, ::-1]).reshape(h, -1)
    files["bmp_topdown.bmp"] = bmp_bytes(w, h, 24, bmp_rows(bgr, 24), top_down=True)
    v = small.astype(np.uint16)
    p565 = ((v[..., 0] >> 3) << 11) | ((v[..., 1] >> 2) << 5) | (v[..., 2] >> 3)
    files["bmp_565.bmp"] = bmp_bytes(w, h, 16, bmp_rows(p565.astype("<u2").view(np.uint8), 16)[::-1],
                                     compression=3, masks=struct.pack("<3I", 0xF800, 0x7E0, 0x1F))
    rgba = np.concatenate([small, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], axis=2)
    files["bmp_v5_rgba.bmp"] = bmp_bytes(
        w, h, 32, bmp_rows(np.ascontiguousarray(rgba).reshape(h, -1), 32)[::-1], compression=3,
        header=124, masks=struct.pack("<4I", 0xFF, 0xFF00, 0xFF0000, 0xFF000000))
    files["bmp_rle8.bmp"] = bmp_bytes(w, h, 8, [rle_bytes(idx * 9, False)], pal256, compression=1)
    files["bmp_rle4.bmp"] = bmp_bytes(w, h, 4, [rle_bytes(idx, True)], pal16, compression=2)
    return files


def pil_bytes(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def upload_kinds(rng: np.random.Generator, names: list, small: np.ndarray,
                 img: np.ndarray) -> dict[str, bytes]:
    """GIF, TIFF, PNM, ICO, CUR and TGA files, and lossless JPEGs with
    subsampled components; a GIF and an LZW TIFF of the first eval
    drawing, pixel for pixel its PNG's, for the web UI on the card."""
    files = {}
    drawing = np.asarray(Image.open(EVAL / f"{names[0]}.png").convert("RGB"))
    # the drawing's own colours (103) as the palette: the GIF holds its pixels
    colours, inverse = np.unique(drawing.reshape(-1, 3), axis=0, return_inverse=True)
    exact = Image.fromarray(inverse.reshape(drawing.shape[:2]).astype(np.uint8), "P")
    exact.putpalette(colours.reshape(-1).tolist())
    files[f"eval/{names[0]}.gif"] = pil_bytes(exact, "GIF")
    files[f"eval/{names[0]}.tif"] = pil_bytes(Image.fromarray(drawing), "TIFF",
                                              compression="tiff_lzw")
    h, w = small.shape[:2]
    quant = Image.fromarray(small).quantize(32)
    idx = np.asarray(quant)
    pal = bytes(quant.getpalette()[:96])
    grey = np.asarray(Image.fromarray(small).convert("L"))
    # GIF: PIL's LZW; offsets, transparency, local tables, interlace (here)
    files["gif_pil.gif"] = pil_bytes(quant, "GIF")
    files["gif_offset_transparent.gif"] = gif_bytes(w + 20, h + 9, (13, 5, w, h), idx,
                                                    gpal=pal, transparency=7, comment=b"fixture")
    lpal = rng.integers(0, 256, 96, dtype=np.uint8).tobytes()
    files["gif_local_interlaced.gif"] = gif_bytes(w, h, (0, 0, w, h), idx, gpal=pal, lpal=lpal,
                                                  interlace=True, version=b"GIF87a")
    files["gif_grey.gif"] = gif_bytes(w, h, (0, 0, w, h), grey >> 4, min_bits=4)
    # TIFF
    rgba = np.concatenate([small, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], axis=2)
    premul = rgba.copy()
    premul[:, :, :3] = (small.astype(np.int32) * rgba[:, :, 3:] // 255).astype(np.uint8)
    cmyk = np.concatenate([255 - small, (np.arange(w) * 80 // w).astype(np.uint8)[None, :, None]
                           .repeat(h, 0)], axis=2)
    cmap = rng.integers(0, 65536, (16, 3))
    files["tiff_pil_lzw.tif"] = pil_bytes(Image.fromarray(small), "TIFF", compression="tiff_lzw")
    files["tiff_rgb_strips.tif"] = tiff_bytes(small, rows_per_strip=10)
    files["tiff_rgb_lzw_predictor.tif"] = tiff_bytes(small, compression=5, predictor=2,
                                                     rows_per_strip=16)
    files["tiff_rgba_deflate_tiles.tif"] = tiff_bytes(rgba, compression=32946, predictor=2,
                                                      tile=(32, 16), extra=(2,))
    files["tiff_rgba_assoc_packbits_mm.tif"] = tiff_bytes(premul, compression=32773, extra=(1,),
                                                          big_endian=True, rows_per_strip=7)
    files["tiff_planar_lzw.tif"] = tiff_bytes(small, compression=5, planar=2, rows_per_strip=20)
    files["tiff_planar_tiles_deflate8.tif"] = tiff_bytes(small, compression=8, planar=2,
                                                         tile=(48, 32))
    files["tiff_cmyk.tif"] = tiff_bytes(cmyk, photometric=5, compression=5)
    files["tiff_palette4.tif"] = tiff_bytes((idx % 16)[:, :, None], bits=4, photometric=3,
                                            colormap=cmap, compression=32773)
    files["tiff_grey4_whiteiszero.tif"] = tiff_bytes((grey >> 4)[:, :, None], bits=4,
                                                     photometric=0)
    files["tiff_bilevel_packbits.tif"] = tiff_bytes((grey > 128)[:, :, None].astype(np.uint8),
                                                    bits=1, photometric=1, compression=32773)
    files["tiff_bilevel_fill2.tif"] = tiff_bytes((grey > 100)[:, :, None].astype(np.uint8),
                                                 bits=1, photometric=0, fill_order=2)
    files["tiff_grey_orientation_6.tif"] = tiff_bytes(grey[:, :, None], photometric=1,
                                                      compression=8, orientation=6)
    files["tiff_rgb_orientation_3_tiles.tif"] = tiff_bytes(small, tile=(16, 16), orientation=3)
    # PNM
    files["pnm_p1.pbm"] = pnm_bytes("P1", grey[:20, :30] > 128, comment=b"plain bitmap")
    files["pnm_p2_maxval_1000.pgm"] = pnm_bytes("P2", grey[:20, :30].astype(np.int64) * 1000 // 255,
                                                maxval=1000, comment=b"wide grey")
    files["pnm_p3_maxval_15.ppm"] = pnm_bytes("P3", small[:20, :30] >> 4, maxval=15,
                                              comment=b"plain pixmap")
    files["pnm_p4.pbm"] = pil_bytes(Image.fromarray(grey > 128), "PPM")
    files["pnm_p5.pgm"] = pil_bytes(Image.fromarray(grey), "PPM")
    files["pnm_p5_16bit.pgm"] = pnm_bytes("P5", grey.astype(np.int64) * 257 // 2, maxval=65535)
    files["pnm_p6.ppm"] = pil_bytes(Image.fromarray(small), "PPM")
    files["pnm_p6_maxval_1023.ppm"] = pnm_bytes("P6", small.astype(np.int64) * 4 + 3, maxval=1023)
    # ICO and CUR
    files["ico_png.ico"] = pil_bytes(Image.fromarray(rgba[:64, :64]), "ICO",
                                     sizes=[(16, 16), (32, 32), (64, 64)])
    pal8 = rng.integers(0, 256, 256 * 4, dtype=np.uint8).tobytes()
    pal16 = rng.integers(0, 256, 16 * 4, dtype=np.uint8).tobytes()
    idx8 = rng.integers(0, 256, (48, 48), dtype=np.uint8)
    mask = rng.random((48, 48)) < 0.3
    files["ico_dib.ico"] = icon_bytes([
        (32, 32, 4, 16, dib_bytes(idx8[:32, :32] % 16, 4, pal16)),
        (48, 48, 8, 0, dib_bytes(idx8, 8, pal8, mask)),
        (48, 48, 4, 16, dib_bytes(idx8 % 16, 4, pal16, mask))])
    bgra = np.ascontiguousarray(rgba[:40, :40][:, :, [2, 1, 0, 3]])
    files["ico_dib32.ico"] = icon_bytes([(40, 40, 32, 0, dib_bytes(bgra, 32, b""))])
    files["cursor.cur"] = icon_bytes([(32, 32, 4, 16, dib_bytes(idx8[:32, :32] % 16, 4, pal16)),
                                      (48, 48, 8, 0, dib_bytes(idx8, 8, pal8, mask))], kind=2,
                                     hotspots=[(3, 4), (10, 12)])
    # TGA
    bgr = np.ascontiguousarray(small[:, :, ::-1])
    files["tga_pil_rgb.tga"] = pil_bytes(Image.fromarray(small), "TGA")
    files["tga_pil_rle_rgba.tga"] = pil_bytes(Image.fromarray(rgba), "TGA", rle=True)
    files["tga_pil_palette.tga"] = pil_bytes(quant, "TGA")
    files["tga_grey_rle.tga"] = tga_bytes(grey[:, :, None], 11, 8, top=True)
    v = small.astype(np.uint16) >> 3
    p15 = ((v[..., 0] << 10) | (v[..., 1] << 5) | v[..., 2] | 0x8000).astype("<u2")
    files["tga_16bit_top_right.tga"] = tga_bytes(p15.view(np.uint8).reshape(h, w, 2), 2, 16,
                                                 top=True, right=True, ident=b"tga fixture")
    c16 = (rng.integers(0, 1 << 15, 40)).astype("<u2").tobytes()
    files["tga_cmap16_rle.tga"] = tga_bytes((idx % 40 + 5)[:, :, None].astype(np.uint8), 9, 8,
                                            cmap=c16, cmap_start=5, cmap_depth=16)
    files["tga_bgra_right.tga"] = tga_bytes(np.ascontiguousarray(rgba[:, :, [2, 1, 0, 3]]), 2, 32,
                                            right=True)
    # lossless JPEG with subsampled components (libjpeg-turbo reads IDs 1-3
    # as RGB in lossless mode and upsamples by replication)
    planes = [img[:63, :97, 0], img[:63:2, :97:2, 1], img[:63:2, :97:2, 2]]
    files["lossless_420.jpg"] = lossless_jpeg_sampled(
        [np.ascontiguousarray(p) for p in planes], [(2, 2), (1, 1), (1, 1)], predictor=1)
    planes = [img[:64, :96, 0], img[:64, :96:2, 1], img[:64, :96:2, 2]]
    files["lossless_422.jpg"] = lossless_jpeg_sampled(
        [np.ascontiguousarray(p) for p in planes], [(2, 1), (1, 1), (1, 1)], predictor=7, pt=2)
    return files


def psd_bytes(mode: int, bits: int, planes: list, compression: int = 0, table: bytes = b"",
              extra_channels: int = 0) -> bytes:
    """A PSD of (h, w) uint8 planes (1-bit planes already packed, rows of
    ceil(w / 8) bytes), raw or PackBits rows, no resources or layers."""
    h = planes[0].shape[0]
    w = planes[0].shape[1] * (8 if bits == 1 else 1)
    planes = planes + [np.full_like(planes[0], 77)] * extra_channels
    head = b"8BPS" + struct.pack(">H6sHIIHH", 1, bytes(6), len(planes), h, w, bits, mode)
    head += struct.pack(">I", len(table)) + table + struct.pack(">II", 0, 0)
    if compression == 0:
        return head + struct.pack(">H", 0) + b"".join(p.tobytes() for p in planes)
    rows = [packbits_encode(r.tobytes()) for p in planes for r in p]
    return (head + struct.pack(">H", 1) + struct.pack(f">{len(rows)}H", *map(len, rows))
            + b"".join(rows))


def qoi_bytes(px: np.ndarray) -> bytes:
    """QOI of (h, w, 3 or 4) uint8 pixels, every operation the format has."""
    h, w, ch = px.shape
    flat = np.concatenate([px.reshape(-1, ch), np.full((h * w, 4 - ch), 255, np.uint8)], 1)
    out = bytearray(b"qoif" + struct.pack(">IIBB", w, h, ch, 0))
    seen = [(0, 0, 0, 0)] * 64
    prev, run = (0, 0, 0, 255), 0
    for p in map(tuple, flat.tolist()):
        if p == prev:
            run += 1
            if run == 62:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        k = (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64
        dr, dg, db = ((p[i] - prev[i] + 128) % 256 - 128 for i in range(3))
        if seen[k] == p:
            out.append(k)
        elif p[3] != prev[3]:
            out += bytes((0xFF, *p))
        elif -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
            out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2))
        elif -32 <= dg <= 31 and -8 <= dr - dg <= 7 and -8 <= db - dg <= 7:
            out += bytes((0x80 | (dg + 32), (dr - dg + 8) << 4 | (db - dg + 8)))
        else:
            out += bytes((0xFE, *p[:3]))
        seen[k] = p
        prev = p
    if run:
        out.append(0xC0 | (run - 1))
    return bytes(out) + bytes(7) + b"\x01"


def pcx_bytes(lines: np.ndarray, w: int, bits: int, planes: int, palette: bytes = bytes(48),
              tail: bytes = b"", version: int = 5, stride: int = None) -> bytes:
    """A PCX of (h, planes · stride) line bytes, run-length coded (runs kept
    inside each line)."""
    h = lines.shape[0]
    stride = stride or lines.shape[1] // planes
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1, h - 1, 72, 72)
    head += palette.ljust(48, b"\x00") + bytes([0, planes]) + struct.pack("<HH", stride, 1)
    head = head.ljust(128, b"\x00")
    body = bytearray()
    for line in lines.tolist():
        i = 0
        while i < len(line):
            j = i
            while j < len(line) and j - i < 63 and line[j] == line[i]:
                j += 1
            if j - i > 1 or line[i] >= 0xC0:
                body += bytes((0xC0 | (j - i), line[i]))
            else:
                body.append(line[i])
            i = j
    return head + bytes(body) + tail


def jpeg_tiff_bytes(img: np.ndarray, rows_per_strip: int, quality: int = 85) -> bytes:
    """A YCbCr (photometric 6, 4:2:0) JPEG-compressed TIFF: each strip a
    JPEG stream of PIL's without its tables, which go into JPEGTables."""
    h, w = img.shape[:2]
    tables, chunks = None, []
    for y in range(0, h, rows_per_strip):
        jpg = jpeg_pil(np.ascontiguousarray(img[y:y + rows_per_strip]), quality=quality,
                       subsampling=2)
        segs, pos = [], 2
        while jpg[pos + 1] != 0xDA:
            (n,) = struct.unpack(">H", jpg[pos + 2:pos + 4])
            segs.append((jpg[pos + 1], jpg[pos:pos + 2 + n]))
            pos += 2 + n
        tables = b"\xff\xd8" + b"".join(b for m, b in segs if m in (0xDB, 0xC4)) + b"\xff\xd9"
        chunks.append(b"\xff\xd8" + b"".join(b for m, b in segs if m not in (0xDB, 0xC4, 0xE0))
                      + jpg[pos:])
    return tiff_bytes(img, photometric=6, compression=7, rows_per_strip=rows_per_strip,
                      chunks=chunks, more={347: (7, tables), 530: (3, [2, 2])})


def queue_19a_kinds(rng: np.random.Generator, names: list, small: np.ndarray) -> dict[str, bytes]:
    """TIFFs of wide, signed and floating-point samples and BigTIFFs; a
    16-bit RGB TIFF of the first eval drawing (each sample v · 257, so
    its high bytes are the PNG's pixels) for the web UI on the card; QOI,
    PCX, PSD and Pillow's own PNM variants."""
    files = {}
    drawing = np.asarray(Image.open(EVAL / f"{names[0]}.png").convert("RGB"))
    files[f"eval/{names[0]}_16bit.tif"] = tiff_bytes(drawing.astype(np.uint16) * 257, bits=16,
                                                     compression=8, predictor=2,
                                                     rows_per_strip=64)
    small = np.ascontiguousarray(small[:41, :59])  # the fixture set stays under 2 MB
    h, w = small.shape[:2]
    grey = np.asarray(Image.fromarray(small).convert("L")).astype(np.int64)
    wide = grey * 300 + rng.integers(0, 300, (h, w))  # spans 0-76500: clamps above 255
    files["tiff16_grey.tif"] = pil_bytes(Image.fromarray((wide // 2).astype(np.uint16), "I;16"),
                                         "TIFF")
    files["tiff16_grey_mm_lzw.tif"] = tiff_bytes((wide // 300)[:, :, None], bits=16,
                                                 photometric=1, compression=5, predictor=2,
                                                 big_endian=True, rows_per_strip=20)
    files["tiff16_grey_whiteiszero.tif"] = tiff_bytes((wide // 600)[:, :, None], bits=16,
                                                      photometric=0, compression=32773)
    files["tiff16_rgb_deflate_tiles.tif"] = tiff_bytes(
        small.astype(np.int64) * 257 + rng.integers(0, 257, small.shape), bits=16,
        compression=32946, tile=(32, 16), predictor=2)
    rgba16 = np.concatenate([small.astype(np.int64) * 257,
                             rng.integers(0, 65536, (h, w, 1))], axis=2)
    files["tiff16_rgba_mm.tif"] = tiff_bytes(rgba16, bits=16, extra=(2,), big_endian=True)
    premul = rgba16.copy()
    premul[:, :, :3] = premul[:, :, :3] * premul[:, :, 3:] // 65535
    files["tiff16_rgba_assoc_lzw.tif"] = tiff_bytes(premul, bits=16, extra=(1,), compression=5)
    files["tiff16_cmyk.tif"] = tiff_bytes(
        np.concatenate([65535 - small.astype(np.int64) * 257, (wide % 65536)[:, :, None]], 2),
        bits=16, photometric=5, rows_per_strip=30)
    files["tiff16_rgb_planar_lzw.tif"] = tiff_bytes(small.astype(np.int64) * 251, bits=16,
                                                    planar=2, compression=5)
    files["tiff32_grey.tif"] = tiff_bytes((wide // 4)[:, :, None], bits=32, photometric=1,
                                          compression=8)
    files["tiff12_grey_lzw.tif"] = tiff_bytes((wide // 19)[:, :, None], bits=12, photometric=1,
                                              compression=5, rows_per_strip=9)
    files["tiff_int8.tif"] = tiff_bytes((grey - 128)[:, :, None], photometric=1, sample_format=2)
    files["tiff_int16_mm.tif"] = tiff_bytes((wide - 20000)[:, :, None] // 2, bits=16,
                                            photometric=1, sample_format=2, big_endian=True)
    files["tiff_int32_lzw.tif"] = tiff_bytes((wide - 300)[:, :, None], bits=32, photometric=1,
                                             sample_format=2, compression=5, predictor=2)
    files["tiff_float32.tif"] = pil_bytes(
        Image.fromarray((grey * 1.3 - 40 + rng.random((h, w))).astype(np.float32), "F"), "TIFF")
    files["tiff_float32_mm_deflate.tif"] = tiff_bytes(
        (grey * 1.3 - 40 + rng.random((h, w)))[:, :, None], bits=32, photometric=1,
        sample_format=3, big_endian=True, compression=8, rows_per_strip=25)
    files["bigtiff_rgb_lzw.tif"] = tiff_bytes(small, compression=5, rows_per_strip=16,
                                              bigtiff=True)
    files["bigtiff_grey16_tiles.tif"] = tiff_bytes((wide // 300)[:, :, None], bits=16,
                                                   photometric=1, tile=(32, 32), bigtiff=True)
    files["tiff_int16_mm_lzw.tif"] = tiff_bytes((wide - 20000)[:, :, None] // 2, bits=16,
                                                photometric=1, sample_format=2,
                                                big_endian=True, compression=5)
    # CCITT: PIL's T.6 of the eval drawing's ink, T.4 2-D with fill bits, and
    # (written here from PIL's strips) MH in min-is-white, T.6 in fill order 2
    ink = np.asarray(Image.fromarray(drawing).convert("L")) < 128
    files["tiff_ccitt_g4_drawing.tif"] = pil_bytes(Image.fromarray(ink), "TIFF",
                                                   compression="group4")
    files["tiff_ccitt_g3_2d_fill.tif"] = pil_bytes(Image.fromarray(ink), "TIFF",
                                                   compression="group3",
                                                   tiffinfo={292: 5, 278: 64})
    for name, comp, scheme in (("tiff_ccitt_mh_whiteiszero.tif", "tiff_ccitt", 2),
                               ("tiff_ccitt_g4_fill2.tif", "group4", 4)):
        pil = pil_bytes(Image.fromarray(ink[:120, :200]), "TIFF", compression=comp)
        tags = Image.open(io.BytesIO(pil)).tag_v2
        strip = pil[tags[273][0]:tags[273][0] + tags[279][0]]
        fill2 = scheme == 4
        if fill2:
            strip = bytes(int(f"{b:08b}"[::-1], 2) for b in strip)
        files[name] = tiff_bytes(ink[:120, :200, None].astype(np.uint8), bits=1,
                                 photometric=1 if fill2 else 0, compression=scheme,
                                 chunks=[strip], fill_order=2 if fill2 else 1)
    # JPEG compression: PIL's (RGB and grey through libtiff), YCbCr strips here
    files["tiff_jpeg_pil_rgb.tif"] = pil_bytes(Image.fromarray(small), "TIFF",
                                               compression="jpeg")
    files["tiff_jpeg_pil_grey.tif"] = pil_bytes(Image.fromarray(small).convert("L"), "TIFF",
                                                compression="jpeg", quality=60)
    files["tiff_jpeg_ycbcr_strips.tif"] = jpeg_tiff_bytes(small, 32)
    # QOI: PIL's writer, and every operation (written here)
    rgba = np.concatenate([small, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], axis=2)
    rgba[h // 2:, :, 3] = 255
    files["qoi_pil_rgb.qoi"] = pil_bytes(Image.fromarray(small), "QOI")
    files["qoi_rgba_every_op.qoi"] = qoi_bytes(rgba)
    # PCX: PIL's writer for 1-bit, grey, palette and RGB; 1 bit in 2 and 4
    # planes with the header palette, an odd width, an even stride given
    quant = Image.fromarray(small).quantize(16)
    g8 = np.asarray(Image.fromarray(small).convert("L"))
    files["pcx_pil_1bit.pcx"] = pil_bytes(Image.fromarray(g8 > 128), "PCX")
    files["pcx_pil_grey.pcx"] = pil_bytes(Image.fromarray(g8), "PCX")
    files["pcx_pil_palette.pcx"] = pil_bytes(quant, "PCX")
    files["pcx_pil_rgb.pcx"] = pil_bytes(Image.fromarray(small), "PCX")
    idx = np.asarray(quant)
    for planes in (2, 4):
        s_ = (w + 7) // 8
        line = np.concatenate([np.packbits((idx >> k) & 1, axis=1) for k in range(planes)], 1)
        files[f"pcx_{planes}planes.pcx"] = pcx_bytes(
            line, w, 1, planes, rng.integers(0, 256, 48, dtype=np.uint8).tobytes(), stride=s_)
    odd = small[:, :w - (1 - w % 2)]  # an odd width: the stride rounds up to even
    ow = odd.shape[1]
    lines = np.concatenate([np.pad(odd[:, :, c], ((0, 0), (0, 1))) for c in range(3)], 1)
    files["pcx_rgb_odd_width.pcx"] = pcx_bytes(lines, ow, 8, 3, stride=ow + 1)
    # PSD: the merged image of every mode PIL reads, raw and PackBits
    cmyk = np.concatenate([255 - small, g8[:, :, None] // 3], axis=2)
    table = rng.integers(0, 256, 768, dtype=np.uint8).tobytes()
    files["psd_rgb_raw.psd"] = psd_bytes(3, 8, [small[:, :, c] for c in range(3)])
    files["psd_rgba_packbits.psd"] = psd_bytes(3, 8, [rgba[:, :, c] for c in range(4)],
                                               compression=1)
    files["psd_rgb_5channels_packbits.psd"] = psd_bytes(3, 8, [small[:, :, c] for c in range(3)],
                                                        compression=1, extra_channels=2)
    files["psd_cmyk_packbits.psd"] = psd_bytes(4, 8, [255 - cmyk[:, :, c] for c in range(4)],
                                               compression=1)
    files["psd_grey.psd"] = psd_bytes(1, 8, [g8])
    files["psd_indexed.psd"] = psd_bytes(2, 8, [np.asarray(quant)], compression=1, table=table)
    files["psd_bitmap.psd"] = psd_bytes(0, 1, [np.packbits(g8 > 100, axis=1)])
    files["psd_duotone.psd"] = psd_bytes(8, 8, [g8], table=bytes(20))
    # PNM: Pillow's own variants
    fl = (g8.astype(np.float32) * 1.2 - 20 + rng.random((h, w)).astype(np.float32))
    files["pnm_pf_le.pfm"] = f"Pf\n{w} {h}\n-1.0\n".encode() + fl[::-1].astype("<f4").tobytes()
    files["pnm_pf_be.pfm"] = f"Pf\n{w} {h}\n2.5\n".encode() + fl[::-1].astype(">f4").tobytes()
    files["pnm_pyrgba.pnm"] = f"PyRGBA\n{w} {h}\n255\n".encode() + rgba.tobytes()
    files["pnm_pycmyk_maxval_1000.pnm"] = (f"PyCMYK\n{w} {h}\n1000\n".encode()
                                           + (cmyk.astype(np.int64) * 1000 // 255)
                                           .astype(">u2").tobytes())
    files["pnm_p0cmyk.pnm"] = f"P0CMYK\n{w} {h}\n255\n".encode() + cmyk.tobytes()
    files["pnm_pyp.pnm"] = f"PyP\n{w} {h}\n255\n".encode() + np.asarray(quant).tobytes()
    return files


# ------------------------------------------------------------- JPEG 2000
def jp2_box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(body), kind) + body


def jp2_boxes(data: bytes, start: int = 12) -> list:
    """[(type, body)] of the top-level boxes after the signature."""
    out, pos = [], start
    while pos < len(data):
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        out.append((kind, data[pos + 8:pos + size]))
        pos += size
    return out


def jp2_rewrite(jp2: bytes, header) -> bytes:
    """The JP2 with its jp2h sub-boxes replaced by header([(type, body)])."""
    out = jp2[:12]
    for kind, body in jp2_boxes(jp2):
        if kind == b"jp2h":
            body = b"".join(jp2_box(k, b) for k, b in header(jp2_boxes(body, 0)))
        out += jp2_box(kind, body)
    return out


def j2k_split(cs: bytes):
    """(main header, [(tile-part header from SOT through SOD, data)]) of a
    codestream whose tile-parts all give Psot."""
    pos = cs.index(b"\xff\x90", 2)
    while True:  # the first SOT that starts a marker segment of length 10
        if cs[pos + 2:pos + 4] == b"\x00\x0a":
            break
        pos = cs.index(b"\xff\x90", pos + 1)
    main, parts = cs[:pos], []
    while cs[pos:pos + 2] == b"\xff\x90":
        psot = struct.unpack(">I", cs[pos + 6:pos + 10])[0]
        at = pos + 12
        while cs[at:at + 2] != b"\xff\x93":
            at += 2 + struct.unpack(">H", cs[at + 2:at + 4])[0]
        parts.append((cs[pos:at + 2], cs[at + 2:pos + psot]))
        pos += psot
    assert cs[pos:] == b"\xff\xd9"
    return main, parts


def j2k_join(main: bytes, parts: list) -> bytes:
    """A codestream from j2k_split's pieces, each Psot set anew."""
    out = main
    for head, data in parts:
        out += head[:6] + struct.pack(">I", len(head) + len(data)) + head[10:] + data
    return out + b"\xff\xd9"


def j2k_marker(code: int, body: bytes) -> bytes:
    return struct.pack(">HH", code, 2 + len(body)) + body


def j2k_packets_moved(cs: bytes, how: str) -> bytes:
    """A one-tile-part-per-tile codestream rewritten without re-encoding:
    "sop_eph" puts an SOP before and an EPH after every packet header
    (COD's Scod bits 1 and 2 set), "ppt" moves each tile's packet headers
    into PPT segments, "ppm" moves them all into the main header's PPM.
    The packets' positions come from the port's decoder
    (io/jpeg2000.packet_spans); PIL's read of the result is the
    reference."""
    import sys

    sys.path.insert(0, str(REPO))
    from circuitvision_tpu_torch.io.jpeg2000 import packet_spans

    spans = packet_spans(cs)
    main, parts = j2k_split(cs)
    starts = [len(main)]
    for head, data in parts[:-1]:
        starts.append(starts[-1] + len(head) + len(data))
    headers = {t: [] for t in range(len(parts))}
    bodies = {t: [] for t in range(len(parts))}
    for tile, h0, h1, b0, b1 in spans.tolist():
        headers[tile].append(cs[h0:h1])
        bodies[tile].append(cs[b0:b1])
    tiles = [struct.unpack(">H", head[4:6])[0] for head, _ in parts]
    new_parts = []
    for k, (head, _data) in enumerate(parts):
        t = tiles[k]
        if how == "sop_eph":
            data = b"".join(j2k_marker(0xFF91, struct.pack(">H", i % 65536)) + hd + b"\xff\x92" + bd
                            for i, (hd, bd) in enumerate(zip(headers[t], bodies[t])))
        else:
            data = b"".join(bodies[t])
        if how == "ppt":
            blob = b"".join(headers[t])
            ppt = b"".join(j2k_marker(0xFF61, bytes([z]) + blob[i:i + 65000])
                           for z, i in enumerate(range(0, len(blob), 65000)))
            head = head[:-2] + ppt + head[-2:]
        new_parts.append((head, data))
    if how == "sop_eph":
        at = main.index(b"\xff\x52")
        main = main[:at + 4] + bytes([main[at + 4] | 6]) + main[at + 5:]
    if how == "ppm":
        blob = b"".join(struct.pack(">I", len(b"".join(headers[t]))) + b"".join(headers[t])
                        for t in tiles)
        main += b"".join(j2k_marker(0xFF60, bytes([z]) + blob[i:i + 65000])
                         for z, i in enumerate(range(0, len(blob), 65000)))
    return j2k_join(main, new_parts)


def jpeg2000_kinds(rng: np.random.Generator, names: list, small: np.ndarray) -> dict[str, bytes]:
    """JPEG 2000 files of PIL's encoder (OpenJPEG 2.5.4): every mode PIL
    writes and reads (L, LA, RGB, RGBA, CMYK, I;16), both wavelets, every
    progression with precincts and 1 to 6 resolutions, tiles with tile
    and image offsets, quality layers in rates and in dB, code-block
    sizes from 4x4 to 64x64, mct 0 and 1, signed samples, PLT, a comment,
    raw codestreams, a cinema profile; files made by rewriting only the
    boxes or markers of PIL-written ones, which PIL reads back as the
    reference: a palette (pclr and cmap on grey and grey+alpha), sYCC
    (colr enumerated space 18), SOP and EPH markers, packet headers in
    PPT and in PPM, a POC restating the COD's order, tiles in reverse
    order, scalar-derived quantization, 4- and 12-bit precision in SIZ;
    a truncated file (PIL raises: no digest); and the smallest eval
    drawing as a lossless 5/3 JP2 and as a 9/7 one, for the web UI on the
    card."""
    files = {}

    def save(im, **kw):
        return pil_bytes(im, "JPEG2000", **kw)

    img = np.ascontiguousarray(small[:61, :77])  # the JPEG 2000 set stays under 600 KB
    h, w = img.shape[:2]
    grey = np.asarray(Image.fromarray(img).convert("L"))
    alpha = rng.integers(0, 256, (h, w), dtype=np.uint8)
    rgba = np.concatenate([img, alpha[:, :, None]], axis=2)
    files["jp2_l.jp2"] = save(Image.fromarray(grey))
    files["jp2_la.jp2"] = save(Image.fromarray(np.stack([grey, alpha], -1), "LA"))
    files["jp2_rgb.jp2"] = save(Image.fromarray(img))
    files["jp2_rgba.jp2"] = save(Image.fromarray(rgba, "RGBA"))
    files["jp2_cmyk.jp2"] = save(Image.fromarray(img).convert("CMYK"))
    wide = (grey.astype(np.int64) * 257 + rng.integers(0, 257, (h, w))).astype(np.uint16)
    files["jp2_i16.jp2"] = save(Image.fromarray(wide, "I;16"))
    files["jp2_i16.j2k"] = save(Image.fromarray(wide // 200, "I;16"), no_jp2=True)
    files["jp2_97.jp2"] = save(Image.fromarray(img), irreversible=True, mct=1)
    files["jp2_97_mct0.j2k"] = save(Image.fromarray(img), irreversible=True, no_jp2=True)
    files["jp2_97_l.jp2"] = save(Image.fromarray(grey), irreversible=True)
    files["jp2_97_rgba.jp2"] = save(Image.fromarray(rgba, "RGBA"), irreversible=True, mct=1)
    files["jp2_53_mct1.j2k"] = save(Image.fromarray(img), mct=1, no_jp2=True)
    for prog, res, prec in (("LRCP", 1, None), ("RLCP", 2, (32, 32)), ("RPCL", 3, (16, 64)),
                            ("PCRL", 4, (64, 16)), ("CPRL", 5, (32, 32))):
        kw = dict(progression=prog, num_resolutions=res, mct=1)
        if prec:
            kw["precinct_size"] = prec
        files[f"jp2_{prog.lower()}.j2k"] = save(Image.fromarray(img), no_jp2=True, **kw)
        files[f"jp2_{prog.lower()}_97.j2k"] = save(Image.fromarray(img), no_jp2=True,
                                                   irreversible=True, **kw)
    big = np.ascontiguousarray(small[:83, :117])
    files["jp2_res6.j2k"] = save(Image.fromarray(big), num_resolutions=6,
                                 precinct_size=(128, 128), progression="RPCL", no_jp2=True)
    files["jp2_tiles.j2k"] = save(Image.fromarray(img), tile_size=(32, 24), no_jp2=True,
                                  progression="PCRL", num_resolutions=3)
    files["jp2_tile_offset.jp2"] = save(Image.fromarray(img), tile_size=(24, 20),
                                        tile_offset=(3, 5), offset=(7, 9), num_resolutions=3,
                                        irreversible=True, mct=1)
    # PIL needs a tile size beside an image offset: one tile holds the image
    files["jp2_offset.jp2"] = save(Image.fromarray(img), offset=(5, 3), tile_size=(w + 5, h + 3),
                                   num_resolutions=4)
    files["jp2_layers_rates.jp2"] = save(Image.fromarray(img), quality_mode="rates",
                                         quality_layers=[40, 10, 3], irreversible=True, mct=1)
    files["jp2_layers_db.jp2"] = save(Image.fromarray(img), quality_mode="dB",
                                      quality_layers=[28, 36, 44], progression="RLCP")
    files["jp2_layers_53.j2k"] = save(Image.fromarray(grey), quality_mode="rates",
                                      quality_layers=[20, 5], no_jp2=True)
    for cw, ch in ((4, 4), (8, 32), (64, 4), (64, 64)):
        files[f"jp2_cblk_{cw}x{ch}.j2k"] = save(Image.fromarray(img), codeblock_size=(cw, ch),
                                                no_jp2=True, irreversible=cw == 8)
    files["jp2_signed.jp2"] = save(Image.fromarray(grey // 2), signed=True)
    files["jp2_plt.j2k"] = save(Image.fromarray(img), plt=True, no_jp2=True,
                                quality_layers=[30, 8], quality_mode="rates")
    files["jp2_comment.jp2"] = save(Image.fromarray(grey), comment="CircuitVision fixtures")
    files["jp2_cinema2k.j2k"] = save(Image.fromarray(img), cinema_mode="cinema2k-24",
                                     no_jp2=True)
    # rewrites of PIL's boxes: palettes (colr sRGB) and sYCC
    idx = rng.integers(0, 12, (h, w), dtype=np.uint8)
    colours = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(10)]
    colours[7] = colours[2]  # a repeated colour: PIL's getcolor keeps the first index

    def pclr(npc: int, comps: int):
        def header(sub):
            out = [(k, b[:3] + struct.pack(">I", 16) if k == b"colr" else b) for k, b in sub]
            entries = [c + ((200,) if npc == 4 else ()) for c in colours]
            body = struct.pack(">HB", len(entries), npc) + bytes([7] * npc)
            out += [(b"pclr", body + b"".join(bytes(c) for c in entries)),
                    (b"cmap", b"".join(struct.pack(">HBB", 0, 1, i) for i in range(npc))
                     + (struct.pack(">HBB", 1, 0, 0) if comps == 2 else b""))]
            return out
        return header
    files["jp2_palette.jp2"] = jp2_rewrite(save(Image.fromarray(idx)), pclr(3, 1))
    files["jp2_palette_rgba.jp2"] = jp2_rewrite(save(Image.fromarray(idx)), pclr(4, 1))
    files["jp2_palette_alpha.jp2"] = jp2_rewrite(
        save(Image.fromarray(np.stack([idx, alpha], -1), "LA")), pclr(3, 2))
    ycc = np.asarray(Image.fromarray(img).convert("YCbCr"))
    files["jp2_sycc.jp2"] = jp2_rewrite(
        save(Image.fromarray(ycc, "RGB"), irreversible=True),
        lambda sub: [(k, b[:3] + struct.pack(">I", 18) if k == b"colr" else b) for k, b in sub])
    # rewrites of PIL's markers
    tiled = save(Image.fromarray(img), tile_size=(32, 32), no_jp2=True, num_resolutions=3,
                 quality_layers=[20, 6], quality_mode="rates", progression="RPCL",
                 precinct_size=(32, 32))
    for how in ("sop_eph", "ppt", "ppm"):
        files[f"jp2_{how}.j2k"] = j2k_packets_moved(tiled, how)
    main, parts = j2k_split(tiled)
    files["jp2_tiles_reversed.j2k"] = j2k_join(main, parts[::-1])
    at = main.index(b"\xff\x52")
    prog, layers, nl = main[at + 5], struct.unpack(">H", main[at + 6:at + 8])[0], main[at + 9]
    poc = j2k_marker(0xFF5F, bytes([0, 0]) + struct.pack(">H", layers)
                     + bytes([nl + 1, 3, prog]))
    files["jp2_poc.j2k"] = j2k_join(main + poc, parts)
    lossy = save(Image.fromarray(img), irreversible=True, no_jp2=True, num_resolutions=4)
    main, parts = j2k_split(lossy)
    at = main.index(b"\xff\x5c")
    qcd = main[at + 5:at + 7]  # the LL band's step: the derived bands' base
    main = main[:at] + j2k_marker(0xFF5C, bytes([(main[at + 4] & 0xE0) | 1]) + qcd) \
        + main[at + 2 + struct.unpack(">H", main[at + 2:at + 4])[0]:]
    files["jp2_derived.j2k"] = j2k_join(main, parts)
    grey_cs = save(Image.fromarray(grey), no_jp2=True, num_resolutions=3)
    for bits in (4, 12):  # SIZ's Ssiz (the first component's at byte 42)
        files[f"jp2_{bits}bit.j2k"] = grey_cs[:42] + bytes([bits - 1]) + grey_cs[43:]
    files["jp2_truncated.jp2"] = files["jp2_rgb.jp2"][:len(files["jp2_rgb.jp2"]) * 2 // 3]
    # the smallest eval drawing, for the upload → netlist check on the card
    smallest = min(names, key=lambda n: Image.open(EVAL / f"{n}.png").size[0]
                   * Image.open(EVAL / f"{n}.png").size[1])
    drawing = Image.open(EVAL / f"{smallest}.png").convert("RGB")
    files[f"eval/{smallest}.jp2"] = save(drawing)
    files[f"eval/{smallest}_97.jp2"] = save(drawing, irreversible=True, quality_layers=[20],
                                            quality_mode="rates")
    return files


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(REPO / "eval_data" / "image_fixtures"))
    args = ap.parse_args(argv)
    out = Path(args.out)
    digests = {}
    for name, data in make(args.seed).items():
        path = out / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
        try:
            arr = pil_rgb(data)
        except OSError:  # a fixture PIL refuses (jp2_truncated.jp2): no digest
            continue
        digests[name] = {"shape": list(arr.shape), "sha256": digest(arr)}
    (out / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
    print(f"{len(digests)} files, {total} bytes in {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
