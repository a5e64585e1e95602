"""The port's GIF, TIFF, PNM, ICO/CUR and TGA readers (io/gif.py,
io/tiff.py, io/pnm.py, io/ico.py, io/tga.py, native/lzw.cpp, through
io/image_io.decode_image) byte-equal to the JAX package's decode_image
(PIL 12.1.0, exif_transpose, convert("RGB")):

  * every such fixture of scripts/make_image_fixtures.py, checked against
    its committed digest too (the card, which has no PIL, checks those);
  * seeded hypothesis sweeps of small random files PIL writes (GIF, TIFF
    in each compression PIL writes, PPM/PGM/PBM, TGA plain and RLE) and
    of files written here (GIF frames at offsets with local tables and
    transparency, TIFF strips and tiles in every supported layout, plain
    PNM at other maxvals, TGA types and origins);
  * the structure PIL reads in its own way (a local grey table, a frame
    grown past the screen, an image whose codes end early, a cursor
    directory with no entry, TGA packets past a row) and the kinds left
    unread, each refused naming it.
"""
import hashlib
import importlib.util
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from circuitvision_tpu.io.image_io import decode_image as jax_decode
from circuitvision_tpu_torch.io import image_io as pio
from circuitvision_tpu_torch.io import lzw

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "eval_data" / "image_fixtures"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
KINDS = (".gif", ".tif", ".pbm", ".pgm", ".ppm", ".ico", ".cur", ".tga")
_spec = importlib.util.spec_from_file_location("make_image_fixtures",
                                               ROOT / "scripts" / "make_image_fixtures.py")
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)


def _same(data: bytes, kind: str = ""):
    """The port's decode equals PIL's, or both refuse (the port with
    ImageFormatError naming `kind`). Returns the image or None."""
    try:
        ref = jax_decode(data)
    except Exception:
        with pytest.raises(pio.ImageFormatError, match=kind):
            pio.decode_image(data)
        return None
    got = pio.decode_image(data)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert got.tobytes() == ref.tobytes()
    return got


def _pil(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("name", sorted(n for n in DIGESTS if n.endswith(KINDS)))
def test_fixtures_equal_jax_and_digest(name):
    got = _same((FIXTURES / name).read_bytes())
    assert got is not None
    assert list(got.shape) == DIGESTS[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == DIGESTS[name]["sha256"]


def _image(rng, h, w, mode):
    a = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    a[:, : w // 2] = a[:1, :1]  # runs, so that the compressors have work
    if mode in ("1", "L", "P"):
        im = Image.fromarray(a[:, :, 0], "L")
        if mode == "1":
            return im.convert("1")
        if mode == "P":
            im = Image.fromarray(a[:, :, 0] % 40, "P")
            im.putpalette(rng.integers(0, 256, 120).tolist())
        return im
    return Image.fromarray(a[:, :, :len(mode)], mode)


@settings(max_examples=40, derandomize=True, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2 ** 16),
       mode=st.sampled_from(["1", "L", "P", "RGB", "RGBA"]), interlace=st.booleans())
def test_pil_written_gif_sweep(h, w, seed, mode, interlace):
    im = _image(np.random.default_rng(seed), h, w, mode)
    _same(_pil(im, "GIF", interlace=interlace), "GIF")


@settings(max_examples=60, derandomize=True, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2 ** 16),
       mode=st.sampled_from(["1", "L", "P", "RGB", "RGBA", "CMYK", "LA"]),
       compression=st.sampled_from([None, "packbits", "tiff_lzw", "tiff_deflate",
                                    "tiff_adobe_deflate"]),
       orientation=st.integers(1, 8))
def test_pil_written_tiff_sweep(h, w, seed, mode, compression, orientation):
    im = _image(np.random.default_rng(seed), h, w, "L" if mode == "LA" else mode)
    if mode in ("CMYK", "LA"):
        im = im.convert(mode)
    kw = {"compression": compression} if compression else {}
    _same(_pil(im, "TIFF", tiffinfo={274: orientation}, **kw), "TIFF")


@settings(max_examples=40, derandomize=True, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2 ** 16),
       mode=st.sampled_from(["1", "L", "RGB"]))
def test_pil_written_pnm_sweep(h, w, seed, mode):
    _same(_pil(_image(np.random.default_rng(seed), h, w, mode), "PPM"), "PNM")


@settings(max_examples=40, derandomize=True, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2 ** 16),
       mode=st.sampled_from(["L", "P", "RGB", "RGBA"]), rle=st.booleans(),
       top=st.booleans())
def test_pil_written_tga_sweep(h, w, seed, mode, rle, top):
    im = _image(np.random.default_rng(seed), h, w, mode)
    _same(_pil(im, "TGA", rle=rle, orientation=1 if top else -1), "TGA")


@settings(max_examples=40, derandomize=True, deadline=None)
@given(h=st.integers(1, 24), w=st.integers(1, 24), seed=st.integers(0, 2 ** 16),
       dx=st.integers(0, 6), dy=st.integers(0, 6), grow=st.integers(-3, 4),
       local=st.sampled_from([None, "colour", "grey"]), glob=st.booleans(),
       transparency=st.sampled_from([None, 0, 3]), interlace=st.booleans(),
       min_bits=st.sampled_from([2, 3, 8]))
def test_written_gif_sweep(h, w, seed, dx, dy, grow, local, glob, transparency, interlace,
                           min_bits):
    """Frames at offsets on screens smaller or larger than they reach,
    global and local tables (a local grey ramp drops to the global
    table), transparency filling the canvas, interlace, code sizes."""
    rng = np.random.default_rng(seed)
    n = 1 << min_bits
    idx = rng.integers(0, min(n, 6), (h, w))
    gpal = rng.integers(0, 256, 3 * min(n, 8), dtype=np.uint8).tobytes() if glob else None
    lpal = {None: None, "colour": rng.integers(0, 256, 18, dtype=np.uint8).tobytes(),
            "grey": bytes(np.repeat(np.arange(6), 3).astype(np.uint8))}[local]
    data = fixtures.gif_bytes(max(1, w + dx + grow), max(1, h + dy + grow), (dx, dy, w, h), idx,
                              gpal=gpal, lpal=lpal, transparency=transparency,
                              interlace=interlace, min_bits=min_bits)
    assert _same(data, "GIF") is not None


def test_gif_whose_codes_end_early_raises():
    """An end code before the last pixel, and a file cut inside its
    sub-blocks: PIL raises "image file is truncated"; so does the port."""
    idx = np.arange(40).reshape(5, 8) % 4
    pal = bytes(range(24))
    full = fixtures.gif_bytes(8, 5, (0, 0, 8, 5), idx, gpal=pal, min_bits=2)
    codes = fixtures.gif_lzw_plain(idx.reshape(-1)[:24], 2)
    short = (full[:13 + 24] + b"\x2c" + struct.pack("<HHHHB", 0, 0, 8, 5, 0) + b"\x02"
             + bytes([len(codes)]) + codes + b"\x00;")
    for data in (short, full[:-6]):
        with pytest.raises(Exception):
            jax_decode(data)
        with pytest.raises(pio.ImageFormatError, match="GIF.*truncated"):
            pio.decode_image(data)


@settings(max_examples=80, derandomize=True, deadline=None)
@given(h=st.integers(1, 30), w=st.integers(1, 30), seed=st.integers(0, 2 ** 16),
       layout=st.sampled_from(["grey1", "grey2", "grey4", "grey8", "la", "p1", "p4", "p8",
                               "rgb", "rgbx", "rgba", "rgba_assoc", "cmyk"]),
       photometric0=st.booleans(), compression=st.sampled_from([1, 5, 8, 32946, 32773]),
       predictor=st.booleans(), planar=st.booleans(), tiled=st.booleans(),
       rows=st.integers(1, 31), big_endian=st.booleans(), fill2=st.booleans())
def test_written_tiff_sweep(h, w, seed, layout, photometric0, compression, predictor, planar,
                            tiled, rows, big_endian, fill2):
    """Every supported sample layout in every supported compression,
    strips of any height and tiles, planar samples, both byte orders, fill
    order 2 (the stored bytes' bits reversed, which libtiff undoes before
    decompressing), horizontal differencing."""
    rng = np.random.default_rng(seed)
    bits, spp, photo, extra = {
        "grey1": (1, 1, 1, ()), "grey2": (2, 1, 1, ()), "grey4": (4, 1, 1, ()),
        "grey8": (8, 1, 1, ()), "la": (8, 2, 1, (2,)), "p1": (1, 1, 3, ()),
        "p4": (4, 1, 3, ()), "p8": (8, 1, 3, ()), "rgb": (8, 3, 2, ()), "rgbx": (8, 4, 2, (0,)),
        "rgba": (8, 4, 2, (2,)), "rgba_assoc": (8, 4, 2, (1,)), "cmyk": (8, 4, 5, ())}[layout]
    if photometric0 and photo == 1:
        photo = 0
    samples = rng.integers(0, 1 << bits, (h, w, spp)).astype(np.uint8)
    cmap = rng.integers(0, 65536, (1 << bits, 3)) if photo == 3 else None
    pred = 2 if predictor and bits == 8 and compression in (5, 8, 32946) else 1
    tile = (16, 16) if tiled and (bits == 8 or not planar) else None
    data = fixtures.tiff_bytes(samples, bits=bits, photometric=photo, compression=compression,
                               predictor=pred, planar=2 if planar and spp > 1 else 1, tile=tile,
                               rows_per_strip=rows, extra=extra, colormap=cmap,
                               big_endian=big_endian,
                               fill_order=2 if fill2 else 1)
    # PIL lists fill order 2 for one sample and 8-bit RGB only, and its own
    # raw decoder (no compression) has no unpacker for 1- to 4-bit palette
    # or 8-bit WhiteIsZero samples in that order
    refused = fill2 and (layout in ("la", "rgbx", "rgba", "rgba_assoc", "cmyk") or (
        compression == 1 and (layout in ("p1", "p4") or (layout == "grey8" and photo == 0))))
    assert (_same(data, "TIFF") is None) == refused


@settings(max_examples=40, derandomize=True, deadline=None)
@given(h=st.integers(1, 20), w=st.integers(1, 20), seed=st.integers(0, 2 ** 16),
       kind=st.sampled_from(["P1", "P2", "P3", "P5", "P6"]),
       maxval=st.sampled_from([1, 7, 200, 255, 256, 1000, 65535]))
def test_written_pnm_sweep(h, w, seed, kind, maxval):
    """Plain and binary maps at maxvals from 1 to 65535, comments inside
    the header and the data."""
    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if kind in ("P3", "P6") else (h, w)
    samples = rng.integers(0, (1 if kind == "P1" else maxval) + 1, shape)
    data = fixtures.pnm_bytes(kind, samples, maxval=maxval, comment=b"sweep")
    assert _same(data, "PNM") is not None


@settings(max_examples=40, derandomize=True, deadline=None)
@given(h=st.integers(1, 20), w=st.integers(1, 20), seed=st.integers(0, 2 ** 16),
       kind=st.sampled_from([(1, 8), (9, 8), (2, 16), (10, 16), (2, 24), (10, 24),
                             (2, 32), (10, 32), (3, 8), (11, 8), (3, 16), (11, 16)]),
       cmap_depth=st.sampled_from([16, 24, 32]), top=st.booleans(), right=st.booleans(),
       start=st.integers(0, 3))
def test_written_tga_sweep(h, w, seed, kind, cmap_depth, top, right, start):
    """Every image type and depth PIL takes, colour maps of 16, 24 and 32
    bits from a first entry index, both origins and mirroring."""
    rng = np.random.default_rng(seed)
    itype, depth = kind
    px = rng.integers(0, 256, (h, w, depth // 8), dtype=np.uint8)
    px[:, : w // 2] = px[:1, :1]
    cmap = b""
    if itype & 7 == 1:
        px = (px % 12 + start).astype(np.uint8)
        cmap = rng.integers(0, 256, 12 * cmap_depth // 8, dtype=np.uint8).tobytes()
    data = fixtures.tga_bytes(px, itype, depth, cmap=cmap, cmap_start=start,
                              cmap_depth=cmap_depth, top=top, right=right)
    # PIL fails on a 32-bit colour map ("unrecognized raw mode")
    assert (_same(data, "TGA") is None) == (itype & 7 == 1 and cmap_depth == 32)


def test_tga_packet_past_its_row_is_refused():
    px = np.zeros((2, 3, 3), np.uint8)
    head = bytearray(fixtures.tga_bytes(px, 10, 24)[:18])
    data = bytes(head) + bytes([0x80 | 5]) + bytes(3)  # one packet of 6 pixels over 2 rows
    with pytest.raises(Exception):
        jax_decode(data)
    with pytest.raises(pio.ImageFormatError, match="TGA.*overrun"):
        pio.decode_image(data)


def test_icons_pick_the_entry_pil_loads():
    """ICO: the largest entry, the lowest colour depth among equals; PNG
    and DIB entries; CUR: the last entry wider and taller; a cursor
    directory with no entry falls through to TGA, as in PIL."""
    rng = np.random.default_rng(5)
    pal = rng.integers(0, 256, 16 * 4, dtype=np.uint8).tobytes()
    pal8 = rng.integers(0, 256, 256 * 4, dtype=np.uint8).tobytes()
    idx = rng.integers(0, 16, (32, 32))
    png = _pil(Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)), "PNG")
    for entries in ([(32, 32, 8, 0, fixtures.dib_bytes(idx, 8, pal8)),
                     (32, 32, 4, 16, fixtures.dib_bytes(idx, 4, pal))],
                    [(16, 16, 4, 16, fixtures.dib_bytes(idx[:16, :16], 4, pal)),
                     (32, 32, 32, 0, png)]):
        got = _same(fixtures.icon_bytes(entries), "ICO")
        assert got.shape == (32, 32, 3)
    cur = fixtures.icon_bytes([(16, 16, 4, 16, fixtures.dib_bytes(idx[:16, :16], 4, pal)),
                               (32, 32, 4, 16, fixtures.dib_bytes(idx, 4, pal)),
                               (20, 40, 4, 16, fixtures.dib_bytes(idx[:20, :20], 4, pal))],
                              kind=2)
    assert _same(cur, "ICO").shape == (32, 32, 3)
    tga = fixtures.tga_bytes(rng.integers(0, 256, (3, 4, 3), dtype=np.uint8), 2, 24)
    assert tga[:4] == b"\x00\x00\x02\x00"
    assert _same(tga, "TGA").shape == (3, 4, 3)


@pytest.mark.parametrize("case", ["jpeg_compression", "ccitt", "16bit", "ycbcr", "float",
                                  "bigtiff", "predictor_4bit"])
def test_unread_tiff_kinds_raise_naming_them(case):
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    if case == "jpeg_compression":  # new-style JPEG is read now; old-style stays refused
        data = fixtures.tiff_bytes(a, compression=6)
        match = "old-style JPEG compression"
    elif case == "ccitt":  # bilevel CCITT is read now; libtiff decodes no other depth
        data = fixtures.tiff_bytes(a[:, :, :1], photometric=1, compression=4,
                                   chunks=[bytes(40)])
        match = "CCITT G4 compression of a grey image"
    elif case == "16bit":  # 16-bit grey is read now; 16-bit grey + alpha PIL refuses
        data = fixtures.tiff_bytes(a[:, :, :2].astype(np.int64) * 200, bits=16, photometric=1,
                                   extra=(2,))
        match = "16-bit samples"
    elif case == "ycbcr":
        data, match = fixtures.tiff_bytes(a, photometric=6), "YCbCr"
    elif case == "float":  # 32-bit float grey is read now; 64-bit PIL refuses
        data = fixtures.tiff_bytes(a[:, :, :1] / 3.0, bits=64, photometric=1, sample_format=3)
        match = "floating-point samples"
    elif case == "bigtiff":  # little-endian BigTIFF is read now; PIL fails on big-endian
        data, match = fixtures.tiff_bytes(a, big_endian=True, bigtiff=True), "BigTIFF"
    else:
        data = fixtures.tiff_bytes(a[:, :, :1] >> 4, bits=4, photometric=1, compression=5,
                                   predictor=2)
        match = "horizontal differencing"
    with pytest.raises(pio.ImageFormatError, match=f"TIFF.*({match})"):
        pio.decode_image(data)
    if case in ("16bit", "float", "bigtiff", "ccitt", "jpeg_compression"):
        with pytest.raises(Exception):
            jax_decode(data)


def test_other_plugins_raise_naming_them():
    """AVIF stays refused by name (ROADMAP Queue A 19b); PCX, QOI and
    JPEG 2000, once refused here, are read (tests/test_torch_port_image_19a.py,
    tests/test_torch_port_jpeg2000.py),
    and what PIL cannot read of them, or of Pillow's own PNM variants,
    raises naming the reader."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    with pytest.raises(pio.ImageFormatError, match="AVIF"):
        pio.decode_image(_pil(Image.fromarray(a), "AVIF"))
    for fmt in ("PCX", "QOI", "JPEG2000"):
        assert _same(_pil(Image.fromarray(a), fmt), fmt) is not None
    pcx4 = bytearray(_pil(Image.fromarray(a), "PCX"))
    pcx4[3], pcx4[65] = 4, 1  # 4 bits in one plane: unknown to PIL
    qoi_cut = _pil(Image.fromarray(a), "QOI")[:20]
    for data, name in ((b"Pf\n2 2\n0\n" + bytes(16), "PNM"), (b"PyP\n2 2\n" + bytes(4), "PNM"),
                       (bytes(pcx4), "PCX"), (qoi_cut, "QOI")):
        with pytest.raises(Exception):
            jax_decode(data)
        with pytest.raises(pio.ImageFormatError, match=name):
            pio.decode_image(data)


def test_lzw_and_packbits_round_trip():
    """The native decoders against the writers' encoders, and TIFF LZW
    against the zlib-free reference of PIL's own writer."""
    rng = np.random.default_rng(3)
    raw = bytes(rng.integers(0, 4, 20000, dtype=np.uint8)) + bytes(3000) + bytes(range(256)) * 9
    assert lzw.tiff_lzw(fixtures.tiff_lzw_encode(raw), len(raw)) == raw
    assert lzw.packbits(fixtures.packbits_encode(raw), len(raw)) == raw
    idx = rng.integers(0, 16, 5000)
    got, ended = lzw.gif_lzw(fixtures.gif_lzw_plain(idx, 4), 4, 5001)  # room to meet the end code
    assert ended and got.tolist() == idx.tolist()
    with pytest.raises(ValueError, match="past the end of the table"):
        lzw.gif_lzw(bytes([0x84, 0xFF, 0xFF]), 2, 10)
    assert zlib.decompress(zlib.compress(raw)) == raw
