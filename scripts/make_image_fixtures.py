#!/usr/bin/env python3
"""Write the image-input fixtures of the PyTorch port: JPEG and PNG files
of the kinds its reader (circuitvision_tpu_torch/io/image_io.py) takes,
and the SHA-256 of what PIL makes of each.

    python scripts/make_image_fixtures.py [--seed 0] [--out eval_data/image_fixtures]

Needs PIL and cv2 (this script only; the port reads the files without
them). From the eval images (eval_data/images, sorted) and a seeded
generator it writes:

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
