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
  * digests.json — per file: the shape and SHA-256 of
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
        arr = pil_rgb(data)
        digests[name] = {"shape": list(arr.shape), "sha256": digest(arr)}
    (out / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
    print(f"{len(digests)} files, {total} bytes in {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
