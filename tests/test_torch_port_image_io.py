"""The port's PNG reader (io/image_io.py) against the JAX package's
`load_image` (PIL) and against PIL itself: the eval set's images and
masks, and PNGs written here with numpy and zlib for every row filter,
colour type and EXIF orientation."""
import glob
import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from circuitvision_tpu.io.image_io import decode_image as jax_decode
from circuitvision_tpu.io.image_io import load_image as jax_load
from circuitvision_tpu_torch.io import image_io as pio

ROOT = Path(__file__).resolve().parents[1]
IMAGES = sorted(glob.glob(str(ROOT / "eval_data" / "images" / "*.png")))
MASKS = sorted(glob.glob(str(ROOT / "eval_data" / "masks" / "*.png")))


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


@pytest.mark.parametrize("make,match", [
    (lambda: _pil_bytes(Image.new("RGB", (8, 8)), "JPEG"), "JPEG"),
    (lambda: _interlaced(), "interlaced"),
    (lambda: _pil_bytes(Image.new("P", (8, 8)), "PNG"), "palette|colour type 3"),
    (lambda: _pil_bytes(Image.new("I;16", (8, 8)), "PNG"), "bit depth 16"),
])
def test_other_formats_raise_naming_them(make, match):
    with pytest.raises(pio.ImageFormatError, match=match):
        pio.decode_image(make())


def _interlaced() -> bytes:
    """An Adam7 header: the reader refuses before it reads the data."""
    return (pio.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1))
            + _chunk(b"IDAT", zlib.compress(b"\0" * 64)) + _chunk(b"IEND", b""))


def test_corrupt_chunk_raises():
    data = bytearray(_png(np.zeros((4, 4), np.uint8), 0, [0]))
    data[-20] ^= 1  # inside IDAT
    with pytest.raises(pio.ImageFormatError, match="CRC"):
        pio.decode_image(bytes(data))
