"""The port's image reader (io/image_io.py) against the JAX package's
`load_image` (PIL) and against PIL itself: the eval set's images and
masks, PNGs written here with numpy and zlib for every row filter,
colour type, bit depth, interlacing and EXIF orientation, the PNG
fixtures of scripts/make_image_fixtures.py, orientations held only in
XMP (PNG and JPEG), and `format_exif_data` against the JAX function."""
import glob
import importlib.util
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from circuitvision_tpu.io.image_io import decode_image as jax_decode
from circuitvision_tpu.io.image_io import format_exif_data as jax_format_exif
from circuitvision_tpu.io.image_io import format_exif_value as jax_format_value
from circuitvision_tpu.io.image_io import load_image as jax_load
from circuitvision_tpu_torch.io import image_io as pio

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("make_image_fixtures",
                                               ROOT / "scripts" / "make_image_fixtures.py")
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)

IMAGES = sorted(glob.glob(str(ROOT / "eval_data" / "images" / "*.png")))
MASKS = sorted(glob.glob(str(ROOT / "eval_data" / "masks" / "*.png")))
FIXTURES = ROOT / "eval_data" / "image_fixtures"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())


@pytest.mark.parametrize("path", IMAGES, ids=lambda p: Path(p).stem)
def test_eval_images_equal_jax_load_image(path):
    got, ref = pio.load_image(path), jax_load(path)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()


def test_eval_set_holds_what_the_reader_must_read():
    assert len(IMAGES) == len(MASKS) == 63
    rotated = [p for p in IMAGES if b"eXIf" in Path(p).read_bytes()]
    assert [Path(p).stem for p in rotated] == ["exif_0", "exif_1", "exif_2"]
    for p in rotated:  # each orientation turns the stored samples
        assert not np.array_equal(pio.read_png(p), pio.load_image(p))


@pytest.mark.parametrize("path", MASKS, ids=lambda p: Path(p).stem)
def test_eval_masks_equal_pil(path):
    got, ref = pio.read_png(path), np.asarray(Image.open(path))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------ a PNG writer
def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filter_row(row: np.ndarray, prev: np.ndarray, ftype: int, bpp: int) -> bytes:
    r, u = row.astype(np.int64), prev.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
    diag = np.concatenate([np.zeros(bpp, np.int64), u[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(r)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = u
    elif ftype == 3:
        pred = (left + u) // 2
    else:
        pred = np.array([_paeth(a, b, c) for a, b, c in zip(left, u, diag)], np.int64)
    return bytes([ftype]) + ((r - pred) % 256).astype(np.uint8).tobytes()


def _png(samples: np.ndarray, colour: int, filters, exif: bytes = None) -> bytes:
    h, w = samples.shape[:2]
    bpp = {0: 1, 2: 3, 6: 4}[colour]
    rows = samples.reshape(h, w * bpp)
    raw, prev = b"", np.zeros(w * bpp, np.uint8)
    for y in range(h):
        raw += _filter_row(rows[y], prev, filters[y % len(filters)], bpp)
        prev = rows[y]
    out = pio.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
    if exif is not None:
        out += _chunk(b"eXIf", exif)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _exif(orientation: int, order: str) -> bytes:
    """TIFF data with one IFD entry: orientation, SHORT, count 1."""
    e = "<" if order == "II" else ">"
    return (order.encode() + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHI", 0x0112, 3, 1) + struct.pack(e + "H", orientation) + b"\0\0"
            + struct.pack(e + "I", 0))


@pytest.mark.parametrize("colour", [0, 2, 6])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_row_filters_and_colour_types_equal_pil(tmp_path, colour, ftype):
    """Every row filter, alone (and all five mixed in the type-4 case),
    on each colour type: the samples as PIL reads them, and the RGB image
    as the JAX package's decode_image gives it."""
    rng = np.random.default_rng(colour * 10 + ftype)
    shape = (13, 17) if colour == 0 else (13, 17, {2: 3, 6: 4}[colour])
    samples = rng.integers(0, 256, shape, dtype=np.uint8)
    data = _png(samples, colour, [ftype] if ftype < 4 else [4, 0, 1, 2, 3])
    path = tmp_path / "x.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(pio.read_png(str(path)), np.asarray(Image.open(path)))
    np.testing.assert_array_equal(pio.read_png(str(path)), samples)
    got, ref = pio.decode_image(data), jax_decode(data)
    assert got.shape == ref.shape and got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientations_equal_jax_decode_image(orientation, order):
    rng = np.random.default_rng(orientation)
    samples = rng.integers(0, 256, (7, 11, 3), dtype=np.uint8)
    data = _png(samples, 2, [4, 1], exif=_exif(orientation, order))
    got, ref = pio.decode_image(data), jax_decode(data)
    assert got.shape == ref.shape and got.tobytes() == ref.tobytes()
    assert pio.exif_orientation(_exif(orientation, order)) == orientation


def test_unreadable_exif_leaves_the_image_as_jax_does():
    samples = np.random.default_rng(0).integers(0, 256, (5, 6, 3), dtype=np.uint8)
    data = _png(samples, 2, [0], exif=b"XX garbage")
    np.testing.assert_array_equal(pio.decode_image(data), jax_decode(data))
    np.testing.assert_array_equal(pio.decode_image(data), samples)


def _pil_bytes(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _sof_patched(data: bytes, marker: int = None, precision: int = None) -> bytes:
    """A baseline JPEG with its SOF0 marker or sample precision changed."""
    at = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[at + 1] = marker
    if precision is not None:
        out[at + 4] = precision
    return bytes(out)


_JPEG = _pil_bytes(Image.new("RGB", (8, 8), (10, 200, 30)), "JPEG")


def _lossless_jfif() -> bytes:
    """A lossless JPEG with a JFIF marker: YCbCr, which libjpeg-turbo
    will not convert in lossless mode."""
    data = fixtures.lossless_jpeg(np.full((4, 5, 3), 90, np.uint8))
    jfif = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    return data[:2] + jfif + data[2:]


def _cblk_style(jp2: bytes) -> bytes:
    """The JP2's codestream with its COD's code-block style set to BYPASS."""
    # COD: the marker, Lcod 2, Scod, SGcod 4, then NL, xcb, ycb and the style
    at = jp2.index(b"\xff\x52", jp2.index(b"\xff\x4f\xff\x51"))
    return jp2[:at + 12] + b"\x01" + jp2[at + 13:]


@pytest.mark.parametrize("make,match", [
    (lambda: _sof_patched(_JPEG, marker=0xC5), "hierarchical"),
    (lambda: _sof_patched(_JPEG, precision=12), "12-bit"),
    (lambda: _sof_patched(_JPEG, marker=0xCB), "lossless frames with arithmetic coding"),
    (_lossless_jfif, "lossless.*colour conversion"),
    (lambda: _cblk_style(_pil_bytes(Image.new("RGB", (8, 8)), "JPEG2000")),
     "JPEG 2000.*BYPASS"),
    (lambda: _pil_bytes(Image.new("RGB", (8, 8)), "AVIF"), "AVIF.*Queue A 19"),
])
def test_other_formats_raise_naming_them(make, match):
    """What the reader still refuses: 12-bit, hierarchical and arithmetic
    lossless JPEG frames and a lossless frame that would need a colour
    conversion, which PIL refuses too (the JAX decode_image raises on
    each), AVIF, which the JAX server reads through PIL (ROADMAP Queue A
    19b), and a JPEG 2000 codestream whose code-block style PIL's encoder
    never writes (its COD patched to BYPASS). GIF, TIFF and JPEG 2000,
    once refused here, are read now (tests/test_torch_port_image_kinds.py,
    tests/test_torch_port_jpeg2000.py)."""
    data = make()
    if data[:2] == b"\xff\xd8":
        with pytest.raises(Exception):
            jax_decode(data)
    with pytest.raises(pio.ImageFormatError, match=match):
        pio.decode_image(data)


@pytest.mark.parametrize("make", [
    lambda: _pil_bytes(Image.new("CMYK", (8, 8), (1, 2, 3, 4)), "JPEG"),
    lambda: (FIXTURES / "arith.jpg").read_bytes(),
    lambda: (FIXTURES / "lossless.jpg").read_bytes(),
    lambda: _pil_bytes(Image.fromarray(np.arange(8 * 9 * 3, dtype=np.uint8).reshape(8, 9, 3)),
                       "BMP"),
    lambda: _pil_bytes(Image.fromarray(np.arange(8 * 9 * 3, dtype=np.uint8).reshape(8, 9, 3)),
                       "WEBP"),
], ids=["cmyk", "arithmetic", "lossless", "bmp", "webp"])
def test_formerly_refused_kinds_equal_jax(make):
    """The kinds the reader refused until it read them (CMYK, arithmetic
    and lossless JPEG, BMP, WebP): byte-equal to the JAX package's
    decode_image on real files."""
    data = make()
    got, ref = pio.decode_image(data), jax_decode(data)
    assert got.shape == ref.shape and got.tobytes() == ref.tobytes()


def _interlaced() -> bytes:
    """An 8-bit RGB Adam7 PNG."""
    samples = np.random.default_rng(4).integers(0, 256, (13, 11, 3), dtype=np.uint8)
    return fixtures.png_bytes(samples, 8, 2, interlace=True)


@pytest.mark.parametrize("make", [
    lambda: _JPEG,
    _interlaced,
    lambda: _pil_bytes(Image.new("P", (8, 8)), "PNG"),
    lambda: _pil_bytes(Image.new("I;16", (8, 8)), "PNG"),
], ids=["jpeg", "interlaced", "palette", "grey16"])
def test_formerly_refused_formats_equal_jax(make):
    """The four kinds the reader refused before it read JPEG and every PNG
    variant: now byte-equal to the JAX decode_image."""
    data = make()
    got, ref = pio.decode_image(data), jax_decode(data)
    assert got.shape == ref.shape and got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("depth,colour", [(1, 0), (2, 0), (4, 0), (16, 0), (1, 3), (2, 3),
                                          (4, 3), (8, 3), (8, 4), (16, 4), (16, 2), (16, 6)])
@pytest.mark.parametrize("interlace", [False, True])
def test_png_variants_equal_jax(depth, colour, interlace):
    """Every bit depth of every colour type the reader did not take
    before, plain and Adam7, written with every row filter: what PIL's
    convert("RGB") makes of them (a palette's missing entries black, a
    16-bit sample's high byte, 16-bit grey clipped at 255)."""
    rng = np.random.default_rng(depth * 10 + colour)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    hi = 1 << depth
    samples = rng.integers(0, hi, (11, 13, ch))
    if depth == 16 and colour == 0:
        samples = rng.integers(0, 400, (11, 13, 1))  # around the clip at 255
    plte = rng.integers(0, 256, 3 * min(hi, 200), dtype=np.uint8).tobytes() \
        if colour == 3 else None
    data = fixtures.png_bytes(samples, depth, colour, interlace=interlace, plte=plte)
    got, ref = pio.decode_image(data), jax_decode(data)
    assert got.shape == ref.shape and got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("name", sorted(n for n in DIGESTS if n.endswith(".png")))
def test_png_fixtures_equal_jax_and_digest(name):
    data = (FIXTURES / name).read_bytes()
    got, ref = pio.decode_image(data), jax_decode(data)
    assert got.shape == ref.shape and got.tobytes() == ref.tobytes()
    assert list(got.shape) == DIGESTS[name]["shape"]
    assert fixtures.digest(got) == DIGESTS[name]["sha256"]


def _xmp_png(orientation: int, exif: bytes = None, key=b"XML:com.adobe.xmp",
             tag_form=False) -> bytes:
    samples = np.random.default_rng(orientation).integers(0, 256, (6, 10, 3), dtype=np.uint8)
    text = (b"<tiff:Orientation>%d</tiff:Orientation>" % orientation if tag_form
            else fixtures.xmp_packet(orientation))
    extra = (_chunk(b"eXIf", exif) if exif is not None else b"") + fixtures.itxt(key, text)
    return fixtures.png_bytes(samples, 8, 2, extra=extra)


def _xmp_jpeg(orientation: int, exif: bytes = None) -> bytes:
    img = np.random.default_rng(orientation).integers(0, 256, (6, 10, 3), dtype=np.uint8)
    data = _pil_bytes(Image.fromarray(img), "JPEG",
                      **({"exif": b"Exif\x00\x00" + exif} if exif else {}))
    return fixtures.jpeg_with_app1(data, b"http://ns.adobe.com/xap/1.0/\x00"
                                   + fixtures.xmp_packet(orientation))


@pytest.mark.parametrize("fmt", ["png", "png-tag", "jpeg"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_xmp_orientation_equals_jax(fmt, orientation):
    """An orientation held only in XMP rotates as PIL's getexif finds it
    (Pillow 12.1.0: `tiff:Orientation` in the PNG "XML:com.adobe.xmp"
    text or the JPEG XMP segment); a 6 × 10 image comes back 10 × 6 at
    orientations 5-8."""
    data = _xmp_jpeg(orientation) if fmt == "jpeg" else \
        _xmp_png(orientation, tag_form=fmt == "png-tag")
    got, ref = pio.decode_image(data), jax_decode(data)
    assert got.shape == ref.shape and got.tobytes() == ref.tobytes()
    assert got.shape[:2] == ((10, 6) if orientation >= 5 else (6, 10))


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
@pytest.mark.parametrize("exif_orientation", [1, 3])
def test_xmp_disagreeing_with_exif_equals_jax(fmt, exif_orientation):
    """EXIF's orientation tag wins over the XMP's, even at 1."""
    exif = _exif(exif_orientation, "II")
    data = _xmp_jpeg(6, exif) if fmt == "jpeg" else _xmp_png(6, exif)
    got, ref = pio.decode_image(data), jax_decode(data)
    assert got.shape == ref.shape and got.tobytes() == ref.tobytes()
    assert got.shape[:2] == (6, 10)


def _exif_entries(entries, order="<") -> bytes:
    """TIFF data with IFD0 entries (tag, type, count, payload bytes),
    payloads over 4 bytes placed after the IFD."""
    n = len(entries)
    data_at = 8 + 2 + 12 * n + 4
    ifd, tail = struct.pack(order + "H", n), b""
    for tag, typ, count, payload in sorted(entries):
        if len(payload) <= 4:
            ifd += struct.pack(order + "HHI", tag, typ, count) + payload.ljust(4, b"\0")
        else:
            ifd += struct.pack(order + "HHII", tag, typ, count, data_at + len(tail))
            tail += payload
    head = (b"II" if order == "<" else b"MM") + struct.pack(order + "HI", 42, 8)
    return head + ifd + struct.pack(order + "I", 0) + tail


_EXIF_CASES = {
    "software": [(0x0131, 2, 10, b"GIMP 2.10\0"), (0x0112, 3, 1, struct.pack("<H", 6))],
    "nonprintable": [(0x0131, 2, 8, b"Cam\x01\x02era\0")],
    "empty": [(0x0131, 2, 3, b"\x01\x02\0")],
    "bytes": [(0x0131, 7, 6, b"\x00\x01abcd"), (0x0112, 4, 1, struct.pack("<I", 3))],
    "byte_type": [(0x0131, 1, 5, b"hello")],
    "neither": [(0x010F, 2, 6, b"Canon\0")],
    "orientation_only": [(0x0112, 3, 1, struct.pack("<H", 8))],
}


@pytest.mark.parametrize("fmt", ["png", "jpeg", "raw-profile"])
@pytest.mark.parametrize("case", sorted(_EXIF_CASES))
def test_format_exif_data_equals_jax(tmp_path, fmt, case):
    """format_exif_data against the JAX function as it runs here: bytes
    values, strings with non-printables, empty strings, neither tag
    (None); a PNG gives a dict as PIL 12.1.0 reads its EXIF."""
    exif = _exif_entries(_EXIF_CASES[case])
    samples = np.zeros((4, 5, 3), np.uint8)
    if fmt == "jpeg":
        data = _pil_bytes(Image.fromarray(samples), "JPEG", exif=b"Exif\x00\x00" + exif)
    elif fmt == "png":
        data = _png(samples, 2, [0], exif=exif)
    else:
        data = fixtures.png_bytes(samples, 8, 2, extra=fixtures.raw_profile_exif(exif))
    path = tmp_path / f"img.{'jpg' if fmt == 'jpeg' else 'png'}"
    path.write_bytes(data)
    assert pio.format_exif_data(str(path)) == jax_format_exif(str(path))


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_format_exif_data_on_fixtures_equals_jax(name):
    path = str(FIXTURES / name)
    assert pio.format_exif_data(path) == jax_format_exif(path)


@pytest.mark.parametrize("make", [
    lambda: _png(np.zeros((4, 4, 3), np.uint8), 2, [0], exif=b"XX garbage"),
    lambda: _png(np.zeros((4, 4, 3), np.uint8), 2, [0]),
    lambda: b"not an image at all",
    lambda: _pil_bytes(Image.new("RGB", (4, 4)), "JPEG"),
    lambda: _xmp_png(6),
], ids=["garbage-exif", "no-exif", "not-an-image", "jpeg-no-exif", "xmp-only"])
def test_format_exif_data_none_cases_equal_jax(tmp_path, make):
    path = tmp_path / "f.bin"
    path.write_bytes(make())
    assert pio.format_exif_data(str(path)) == jax_format_exif(str(path)) is None


@pytest.mark.parametrize("value", [b"\x00\x01", "abc", "a\x00b\tc", "\x01\x02", "", 6, (1, 2)])
def test_format_exif_value_equals_jax(value):
    assert pio.format_exif_value(value) == jax_format_value(value)


def test_corrupt_chunk_raises():
    data = bytearray(_png(np.zeros((4, 4), np.uint8), 0, [0]))
    data[-20] ^= 1  # inside IDAT
    with pytest.raises(pio.ImageFormatError, match="CRC"):
        pio.decode_image(bytes(data))
