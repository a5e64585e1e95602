"""The port's BMP reader (io/bmp.py through io/image_io.py) byte-equal to
the JAX package's decode_image (PIL 12.1.0's BmpImagePlugin, then
convert("RGB")): every BMP fixture of scripts/make_image_fixtures.py,
checked against its committed digest too; a seeded hypothesis sweep of
sizes, bit depths, header versions, palettes and row order; BI_BITFIELDS
masks, the listed ones read and the others refused; RLE8 and RLE4
streams with end-of-line, delta and absolute runs (PIL's quirks
included) and streams that end short; and the files PIL refuses, refused
here too."""
import hashlib
import importlib.util
import io
import json
import struct
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from circuitvision_tpu.io.image_io import decode_image as jax_decode
from circuitvision_tpu_torch.io import image_io as pio

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "eval_data" / "image_fixtures"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
_spec = importlib.util.spec_from_file_location("make_image_fixtures",
                                               ROOT / "scripts" / "make_image_fixtures.py")
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)


def _same(data: bytes):
    """The port's decode equals PIL's, or both refuse (the port with
    ImageFormatError). Returns the image or None."""
    try:
        ref = jax_decode(data)
    except Exception:
        with pytest.raises(pio.ImageFormatError, match="BMP"):
            pio.decode_image(data)
        return None
    got = pio.decode_image(data)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert got.tobytes() == ref.tobytes()
    return got


@pytest.mark.parametrize("name", sorted(n for n in DIGESTS if n.endswith(".bmp")))
def test_bmp_fixtures_equal_jax_and_digest(name):
    got = _same((FIXTURES / name).read_bytes())
    assert list(got.shape) == DIGESTS[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == DIGESTS[name]["sha256"]


@settings(max_examples=60, derandomize=True, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       mode=st.sampled_from(["1", "L", "P", "RGB", "RGBA"]), seed=st.integers(0, 2 ** 16))
def test_pil_written_sweep_equals_jax(h, w, mode, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    im = Image.fromarray(img)
    im = im.quantize(int(seed % 200) + 2) if mode == "P" else im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "BMP")
    assert _same(buf.getvalue()) is not None


def _palette(rng, n: int, pad: int) -> bytes:
    return rng.integers(0, 256, n * pad, dtype=np.uint8).tobytes()


@settings(max_examples=80, derandomize=True, deadline=None)
@given(h=st.integers(1, 30), w=st.integers(1, 30), bits=st.sampled_from([1, 4, 8, 16, 24, 32]),
       header=st.sampled_from([12, 40, 52, 56, 64, 108, 124]), top_down=st.booleans(),
       colors=st.sampled_from([0, 2, 3]), grey=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_written_layouts_equal_jax(h, w, bits, header, top_down, colors, grey, seed):
    """Bit depths, header versions (OS/2's 3-byte palette entries), row
    order, short palettes (indices past them black) and grey ramps (read
    as PIL's "1" or "L")."""
    rng = np.random.default_rng(seed)
    top_down = top_down and header != 12
    if bits <= 8:
        idx = rng.integers(0, 1 << bits, (h, w), dtype=np.uint8)
        pad = 3 if header == 12 else 4
        n = (colors if colors and header != 12 else 1 << bits)
        pal = _palette(rng, n, pad)
        if grey:
            ramp = (0, 255) if n == 2 else range(n)
            pal = b"".join(bytes([v & 255] * 3) + b"\x00" * (pad - 3) for v in ramp)
        rows = fixtures.bmp_rows(idx, bits)
        data = fixtures.bmp_bytes(w, h, bits, rows if top_down else rows[::-1], pal,
                                  header=header, top_down=top_down)
    else:
        px = rng.integers(0, 256, (h, w * bits // 8), dtype=np.uint8)
        rows = fixtures.bmp_rows(px, 8)
        rows = [r[:(w * bits + 31) // 32 * 4].ljust((w * bits + 31) // 32 * 4, b"\x00")
                for r in rows]
        data = fixtures.bmp_bytes(w, h, bits, rows if top_down else rows[::-1], header=header,
                                  top_down=top_down)
    _same(data)


_MASKS = [(0xF800, 0x7E0, 0x1F, 0), (0x7C00, 0x3E0, 0x1F, 0), (0xFF0000, 0xFF00, 0xFF, 0),
          (0xFF000000, 0xFF0000, 0xFF00, 0), (0xFF000000, 0xFF00, 0xFF, 0),
          (0xFF000000, 0xFF0000, 0xFF00, 0xFF), (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
          (0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF000000, 0xFF00, 0xFF, 0xFF0000),
          (0, 0, 0, 0), (0xF00, 0xF0, 0xF, 0), (0xFF, 0xFF00, 0xFF0000, 0)]


@pytest.mark.parametrize("bits", [16, 24, 32])
@pytest.mark.parametrize("header", [40, 56, 124])
def test_bitfields_equal_jax(bits, header):
    """BI_BITFIELDS with every mask set PIL lists read, the others
    refused (masks after a 40-byte header, inside the longer ones)."""
    rng = np.random.default_rng(bits + header)
    h, w = 7, 9
    stride = (w * bits + 31) // 32 * 4
    rows = [rng.integers(0, 256, stride, dtype=np.uint8).tobytes() for _ in range(h)]
    read = 0
    for m in _MASKS:
        masks = struct.pack("<3I", *m[:3]) if header == 40 else struct.pack("<4I", *m)
        data = fixtures.bmp_bytes(w, h, bits, rows, compression=3, header=header, masks=masks)
        read += _same(data) is not None
    assert read >= 1


def _rle_stream(rng, w: int, rle4: bool, n_ops: int) -> bytes:
    out = bytearray()
    for _ in range(n_ops):
        k = rng.integers(0, 10)
        if k < 5:  # an encoded run, sometimes past the row's end
            out += bytes([int(rng.integers(1, w + 3)), int(rng.integers(0, 256))])
        elif k == 5:  # end of line
            out += b"\x00\x00"
        elif k == 6:  # delta: two bytes PIL drops, then right and up
            out += (b"\x00\x02" + bytes(rng.integers(0, 256, 2, dtype=np.uint8))
                    + bytes([int(rng.integers(0, 4)), int(rng.integers(0, 2))]))
        elif k == 7 and rng.random() < 0.1:  # end of bitmap
            out += b"\x00\x01"
        else:  # an absolute run (RLE4: odd counts lose a pixel in PIL)
            n = int(rng.integers(3, w + 4))
            out += bytes([0, n]) + bytes(rng.integers(0, 256, n // 2 if rle4 else n,
                                                      dtype=np.uint8))
            if len(out) % 2:
                out += b"\x00"
    return bytes(out)


@settings(max_examples=120, derandomize=True, deadline=None)
@given(h=st.integers(1, 8), w=st.integers(1, 20), rle4=st.booleans(), grey=st.booleans(),
       top_down=st.booleans(), cut=st.booleans(), n_ops=st.integers(1, 40),
       seed=st.integers(0, 2 ** 16))
def test_rle_streams_equal_jax(h, w, rle4, grey, top_down, cut, n_ops, seed):
    """RLE8 and RLE4 as PIL's BmpRleDecoder runs them: runs clipped at
    the row's end, end of line, delta (four bytes), end of bitmap,
    absolute runs spilling into the next row and aligned by their
    position in the file, and streams that end short ("not enough image
    data", refused on both sides)."""
    rng = np.random.default_rng(seed)
    bits = 4 if rle4 else 8
    pal = (b"".join(bytes([i, i, i, 0]) for i in range(1 << bits)) if grey
           else _palette(rng, 1 << bits, 4))
    stream = _rle_stream(rng, w, rle4, n_ops)
    if cut:
        stream = stream[:int(rng.integers(0, len(stream) + 1))]
    _same(fixtures.bmp_bytes(w, h, bits, [stream], pal, compression=2 if rle4 else 1,
                             top_down=top_down))


@pytest.mark.parametrize("make,match", [
    (lambda d: d[:14] + struct.pack("<I", 20) + d[18:], "header type"),
    (lambda d: d[:28] + struct.pack("<H", 2) + d[30:], "pixel depth"),
    (lambda d: d[:30] + struct.pack("<I", 4) + d[34:], "JPEG inside"),
    (lambda d: d[:30] + struct.pack("<I", 5) + d[34:], "PNG inside"),
    (lambda d: d[:18] + struct.pack("<i", 0) + d[22:], "no pixels"),
    (lambda d: d[:-7], "truncated"),
    (lambda d: d[:30] + struct.pack("<I", 1) + d[34:], "RLE compression at 24 bits"),
])
def test_refused_files_raise_as_pil_does(make, match):
    """What PIL refuses — an unknown header size or depth, JPEG or PNG
    inside, an empty image, truncated pixels, RLE on 24-bit pixels — is
    refused here with a message naming it."""
    base = fixtures.bmp_bytes(5, 4, 24, [bytes(16)] * 4)
    data = make(base)
    with pytest.raises(Exception):
        jax_decode(data)
    with pytest.raises(pio.ImageFormatError, match=match):
        pio.decode_image(data)


def test_bmp_has_no_orientation():
    """PIL finds no EXIF in a BMP: the image is never rotated."""
    img = np.random.default_rng(0).integers(0, 256, (5, 8, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "BMP")
    assert np.array_equal(_same(buf.getvalue()), img)
    assert pio.format_exif_data(str(FIXTURES / "bmp_rgb.bmp")) is None
