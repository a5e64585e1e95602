"""The image kinds of ROADMAP Queue A 19a in the port's reader
(io/tiff.py's wide samples, CCITT and JPEG compression and BigTIFF,
io/ccitt.py + native/ccitt.cpp, io/qoi.py, io/pcx.py, io/psd.py,
io/pnm.py's Pillow variants, through io/image_io.decode_image) byte-equal
to the JAX package's decode_image (PIL 12.1.0, exif_transpose,
convert("RGB")):

  * every such fixture of scripts/make_image_fixtures.py against its
    committed digest too (the TIFFs among them are in
    test_torch_port_image_kinds.py);
  * seeded hypothesis sweeps of files written here: TIFFs of 12-, 16-
    and 32-bit, signed and float samples in both byte orders, strips and
    tiles, every compression and the predictor, BigTIFF; CCITT T.4 (1-D
    and 2-D), T.6 and modified Huffman TIFFs (PIL's, and re-wrapped in
    min-is-white and fill order 2); JPEG-compressed TIFFs (PIL's RGB and
    grey, YCbCr 4:2:0 strips here); QOI with every
    operation; PCX from PIL's writer and in 2 and 4 bit planes; PSD in
    every mode PIL reads, raw and PackBits; Pillow's PNM variants — a
    file PIL refuses refused too, naming its kind.
"""
import hashlib
import importlib.util
import io
import json
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
KINDS = (".qoi", ".pcx", ".psd", ".pfm", ".pnm")
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


def test_every_19a_kind_has_fixtures():
    names = set(DIGESTS)
    for prefix in ("tiff12_", "tiff16_", "tiff32_", "tiff_int", "tiff_float", "tiff_jpeg_", "tiff_ccitt_",
                   "bigtiff_",
                   "qoi_", "pcx_", "psd_", "pnm_pf", "pnm_py", "pnm_p0"):
        assert any(n.startswith(prefix) for n in names), prefix


@settings(max_examples=80, derandomize=True, deadline=None)
@given(h=st.integers(1, 24), w=st.integers(1, 24), seed=st.integers(0, 2 ** 16),
       kind=st.sampled_from(["grey12", "grey16", "grey16_wiz", "grey32", "int8", "int16",
                             "int32", "float32", "rgb16", "rgba16", "rgba16_assoc", "rgbx16",
                             "cmyk16"]),
       big_endian=st.booleans(), compression=st.sampled_from([1, 5, 8, 32773]),
       predictor=st.booleans(), tiled=st.booleans(), bigtiff=st.booleans())
def test_wide_tiff_sweep(h, w, seed, kind, big_endian, compression, predictor, tiled, bigtiff):
    rng = np.random.default_rng(seed)
    spp = {"rgb16": 3, "rgba16": 4, "rgba16_assoc": 4, "rgbx16": 4, "cmyk16": 4}.get(kind, 1)
    bits = {"int8": 8, "grey12": 12, "grey32": 32, "int32": 32, "float32": 32}.get(kind, 16)
    fmt = 2 if kind.startswith("int") else 3 if kind == "float32" else 1
    if fmt == 3:
        samples = rng.normal(120, 150, (h, w, spp))
    elif fmt == 2:
        samples = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (h, w, spp))
    else:
        samples = rng.integers(0, 1 << bits, (h, w, spp)) >> int(rng.integers(0, bits))
    photometric = {"cmyk16": 5, "grey16_wiz": 0}.get(kind, 2 if spp >= 3 else 1)
    extra = {"rgba16": (2,), "rgba16_assoc": (1,), "rgbx16": (0,)}.get(kind, ())
    data = fixtures.tiff_bytes(
        samples, bits=bits, photometric=photometric, compression=compression,
        predictor=2 if predictor and compression in (5, 8) and fmt != 3 and bits != 12 else 1,
        tile=(16, 16) if tiled else None, rows_per_strip=None if tiled else 5, extra=extra,
        big_endian=big_endian, sample_format=fmt, bigtiff=bigtiff)
    _same(data, "TIFF")


@settings(max_examples=40, derandomize=True, deadline=None)
@given(h=st.integers(1, 60), w=st.integers(1, 200), seed=st.integers(0, 2 ** 16),
       comp=st.sampled_from(["group3", "group4", "tiff_ccitt"]),
       t4=st.sampled_from([None, 1, 4, 5]), rows=st.sampled_from([None, 1, 7]),
       white_is_zero=st.booleans(), fill2=st.booleans())
def test_ccitt_tiff_sweep(h, w, seed, comp, t4, rows, white_is_zero, fill2):
    """PIL's CCITT writers (libtiff), T.4 options and strips as tags; the
    strip re-wrapped here in min-is-white and in fill order 2."""
    rng = np.random.default_rng(seed)
    a = rng.random((h, w)) > rng.uniform(0.05, 0.95)
    a[:, : w // 3] = a[:1, :1]
    info = {**({292: t4} if comp == "group3" and t4 else {}), **({278: rows} if rows else {})}
    data = _pil(Image.fromarray(a), "TIFF", compression=comp, tiffinfo=info)
    if white_is_zero or fill2:
        tags = Image.open(io.BytesIO(data)).tag_v2
        strips = [data[o:o + c] for o, c in zip(tags[273], tags[279])]
        if fill2:
            strips = [bytes(int(f"{b:08b}"[::-1], 2) for b in s) for s in strips]
        scheme = {"group3": 3, "group4": 4, "tiff_ccitt": 2}[comp]
        data = fixtures.tiff_bytes(a[:, :, None].astype(np.uint8), bits=1,
                                   photometric=0 if white_is_zero else 1, compression=scheme,
                                   chunks=strips, rows_per_strip=rows or h,
                                   fill_order=2 if fill2 else 1,
                                   more={292: (4, [t4])} if comp == "group3" and t4 else None)
    assert _same(data, "TIFF") is not None


@settings(max_examples=30, derandomize=True, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70), seed=st.integers(0, 2 ** 16),
       kind=st.sampled_from(["pil_rgb", "pil_grey", "ycbcr"]), quality=st.integers(30, 95),
       rows=st.sampled_from([8, 16, 32]))
def test_jpeg_tiff_sweep(h, w, seed, kind, quality, rows):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    a[:, : w // 2] = a[:1, :1]
    if kind == "ycbcr":
        data = fixtures.jpeg_tiff_bytes(a, rows, quality)
    else:
        im = Image.fromarray(a) if kind == "pil_rgb" else Image.fromarray(a[:, :, 0])
        data = _pil(im, "TIFF", compression="jpeg", quality=quality)
    assert _same(data, "TIFF") is not None


@settings(max_examples=40, derandomize=True, deadline=None)
@given(h=st.integers(1, 30), w=st.integers(1, 30), seed=st.integers(0, 2 ** 16),
       alpha=st.booleans(), pil=st.booleans())
def test_qoi_sweep(h, w, seed, alpha, pil):
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (h, w, 4 if alpha else 3), dtype=np.uint8)
    px[:, : w // 2] = px[:1, :1]  # runs
    px[h // 2:] = np.clip(px[h // 2:].astype(int) // 64 * 64 + 1, 0, 255)  # small steps
    data = _pil(Image.fromarray(px), "QOI") if pil else fixtures.qoi_bytes(px)
    assert _same(data, "QOI") is not None


@settings(max_examples=40, derandomize=True, deadline=None)
@given(h=st.integers(1, 30), w=st.integers(1, 30), seed=st.integers(0, 2 ** 16),
       mode=st.sampled_from(["1", "L", "P", "RGB", "planes2", "planes4"]),
       pad=st.booleans())
def test_pcx_sweep(h, w, seed, mode, pad):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    a[:, : w // 2] = a[:1, :1]
    if mode.startswith("planes"):
        planes = int(mode[-1])
        idx = a[:, :, 0] % (1 << planes)
        s = (w + 7) // 8
        line = np.concatenate([np.pad(np.packbits((idx >> k) & 1, axis=1), ((0, 0), (0, pad)))
                               for k in range(planes)], 1)
        data = fixtures.pcx_bytes(line, w, 1, planes, a.tobytes()[:48], stride=s + pad)
    elif mode == "RGB" and pad:  # a stride one byte longer than the width, as PIL reads it
        lines = np.concatenate([np.pad(a[:, :, c], ((0, 0), (0, 1))) for c in range(3)], 1)
        data = fixtures.pcx_bytes(lines, w, 8, 3, stride=w + 1)
    else:
        im = Image.fromarray(a)
        im = {"1": im.convert("1"), "L": im.convert("L"), "P": im.quantize(7), "RGB": im}[mode]
        data = _pil(im, "PCX")
    _same(data, "PCX")


@settings(max_examples=40, derandomize=True, deadline=None)
@given(h=st.integers(1, 24), w=st.integers(1, 24), seed=st.integers(0, 2 ** 16),
       mode=st.sampled_from([(0, 1), (0, 8), (1, 8), (2, 8), (3, 8), (4, 8), (7, 8), (8, 8),
                             (3, 16)]),
       extra=st.integers(0, 2), packbits=st.booleans(), table=st.booleans())
def test_psd_sweep(h, w, seed, mode, extra, packbits, table):
    rng = np.random.default_rng(seed)
    n = {3: 3, 4: 4, 9: 3}.get(mode[0], 1)
    if mode == (0, 1):
        planes = [np.packbits(rng.random((h, w)) < 0.5, axis=1)]
    else:
        planes = [rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(n)]
        for p in planes:
            p[:, : w // 2] = p[:1, :1]
    pal = rng.integers(0, 256, 768, dtype=np.uint8).tobytes() if table else b""
    data = fixtures.psd_bytes(mode[0], mode[1], planes, compression=int(packbits), table=pal,
                              extra_channels=extra)
    _same(data, "PSD")


@settings(max_examples=40, derandomize=True, deadline=None)
@given(h=st.integers(1, 12), w=st.integers(1, 12), seed=st.integers(0, 2 ** 16),
       magic=st.sampled_from([b"Pf", b"PyP", b"PyRGBA", b"PyCMYK", b"P0CMYK"]),
       maxval=st.sampled_from([1, 15, 255, 1000, 65535]), scale=st.sampled_from([-1.0, 2.0]),
       cut=st.booleans())
def test_pnm_variant_sweep(h, w, seed, magic, maxval, scale, cut):
    rng = np.random.default_rng(seed)
    if magic == b"Pf":
        v = rng.normal(100, 120, (h, w)).astype("<f4" if scale < 0 else ">f4")
        data = b"Pf\n%d %d\n%r\n" % (w, h, scale) + v.tobytes()
    else:
        bands = {b"PyP": 1, b"PyRGBA": 4}.get(magic, 4)
        v = rng.integers(0, maxval + 1, (h, w, bands))
        data = (magic + b"\n%d %d\n%d\n" % (w, h, maxval)
                + v.astype(np.uint8 if maxval < 256 else ">u2").tobytes())
    _same(data[:-3] if cut else data, "PNM")


def test_psd_lab_stays_refused():
    """PIL converts Lab PSDs to RGB; the port refuses them by name
    (ROADMAP Queue A 19a's remainder)."""
    rng = np.random.default_rng(0)
    data = fixtures.psd_bytes(9, 8, [rng.integers(0, 256, (4, 5), dtype=np.uint8)
                                     for _ in range(3)])
    assert jax_decode(data).shape == (4, 5, 3)
    with pytest.raises(pio.ImageFormatError, match="PSD: Lab"):
        pio.decode_image(data)
