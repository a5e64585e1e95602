"""The port's WebP reader (io/webp.py and io/native/webp.cpp through
io/image_io.py) byte-equal to the JAX package's decode_image (PIL 12.1.0
reading through libwebp 1.6.0's WebPAnimDecoder, then exif_transpose and
convert("RGB")): every WebP fixture of scripts/make_image_fixtures.py,
checked against its committed digest too; seeded hypothesis sweeps of
sizes (odd ones included), qualities, methods, lossless and alpha
through PIL's encoder, and of the loop-filter, partition and segment
settings PIL does not expose through libwebp's own encoder
(scripts/image_fixture_writer.cpp); the alpha channel against PIL's
RGBA; the container (EXIF and XMP chunks and their flags, odd-length
chunks, ALPH with and without its flag, an animation's first frame on
its canvas, truncation); and `format_exif_data` against the JAX
function."""
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
from circuitvision_tpu.io.image_io import format_exif_data as jax_format_exif
from circuitvision_tpu_torch.io import image_io as pio
from circuitvision_tpu_torch.io.webp import decode_webp_rgba

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "eval_data" / "image_fixtures"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
_spec = importlib.util.spec_from_file_location("make_image_fixtures",
                                               ROOT / "scripts" / "make_image_fixtures.py")
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)


def _same(data: bytes, alpha: bool = True):
    """The port's decode equals PIL's (and, where PIL's image has alpha,
    the alpha too), or both refuse. Returns the image or None."""
    try:
        ref = jax_decode(data)
    except Exception:
        with pytest.raises(pio.ImageFormatError, match="WebP"):
            pio.decode_image(data)
        return None
    got = pio.decode_image(data)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert got.tobytes() == ref.tobytes()
    im = Image.open(io.BytesIO(data))
    if alpha and im.mode == "RGBA":
        assert np.array_equal(decode_webp_rgba(data)[0][..., 3], np.asarray(im)[..., 3])
    return got


@pytest.mark.parametrize("name", sorted(n for n in DIGESTS if n.endswith(".webp")))
def test_webp_fixtures_equal_jax_and_digest(name):
    got = _same((FIXTURES / name).read_bytes())
    assert list(got.shape) == DIGESTS[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == DIGESTS[name]["sha256"]


def _content(rng, h: int, w: int, kind: str, channels: int) -> np.ndarray:
    if kind == "noise":
        img = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    elif kind == "few":  # a small palette: colour indexing with pixel bundling
        img = (rng.integers(0, 4, (h, w, channels)) * 80).astype(np.uint8)
    else:  # smooth with detail: every predictor and the LZ77 copies get used
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(xx * 7 + yy * 3) % 256, (yy * 11) % 256, ((xx ^ yy) * 5) % 256,
                        (xx * yy) % 256], axis=-1)[..., :channels].astype(np.uint8)
        img[rng.random((h, w)) < 0.05] = 255
    if channels == 4 and kind != "noise":
        img[..., 3] = np.where(rng.random((h, w)) < 0.5, 255, rng.integers(0, 256, (h, w)))
    return img


@settings(max_examples=80, derandomize=True, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70), lossless=st.booleans(),
       quality=st.integers(0, 100), method=st.integers(0, 6), alpha=st.booleans(),
       exact=st.booleans(), kind=st.sampled_from(["noise", "few", "smooth"]),
       seed=st.integers(0, 2 ** 16))
def test_pil_sweep_equals_jax(h, w, lossless, quality, method, alpha, exact, kind, seed):
    img = _content(np.random.default_rng(seed), h, w, kind, 4 if alpha else 3)
    data = fixtures.webp_pil(img, lossless=lossless, quality=quality, method=method, exact=exact)
    assert _same(data) is not None


@pytest.fixture(scope="module")
def writer():
    """scripts/image_fixture_writer.cpp: libwebp's encoder with the
    settings Pillow does not pass on."""
    return fixtures.Writer()


@settings(max_examples=50, derandomize=True, deadline=None)
@given(h=st.integers(1, 90), w=st.integers(1, 90), quality=st.integers(0, 100),
       method=st.integers(0, 6), filter_type=st.integers(0, 1), sharpness=st.integers(0, 7),
       strength=st.integers(0, 100), segments=st.integers(1, 4), partitions=st.integers(0, 3),
       sns=st.integers(0, 100), alpha=st.booleans(), alpha_filtering=st.integers(0, 2),
       seed=st.integers(0, 2 ** 16))
def test_encoder_settings_sweep_equals_jax(writer, h, w, quality, method, filter_type, sharpness,
                                           strength, segments, partitions, sns, alpha,
                                           alpha_filtering, seed):
    """The simple loop filter, sharpness, filter strength, segments, 1 to
    8 token partitions and the alpha filters."""
    img = _content(np.random.default_rng(seed), h, w, "smooth", 4 if alpha else 3)
    data = writer.webp(img, quality=quality, method=method, filter_type=filter_type,
                       sharpness=sharpness, strength=strength, segments=segments,
                       partitions=partitions, sns=sns, alpha_filtering=alpha_filtering)
    assert _same(data) is not None


# ---------------------------------------------------------------- container
def _riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _vp8x(flags: int, w: int, h: int) -> bytes:
    return fixtures._riff_chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
                                + (h - 1).to_bytes(3, "little"))


_IMG = np.random.default_rng(5).integers(0, 256, (21, 33, 3), dtype=np.uint8)
_EXIF = fixtures.exif_blob(6)  # odd length
_XMP = fixtures.xmp_packet(8)


def _image_chunks(lossless: bool, alpha: bool = False) -> list:
    img = np.concatenate([_IMG, _IMG[..., :1]], axis=2) if alpha else _IMG
    return [c for c in fixtures._riff_chunks(fixtures.webp_pil(img, lossless=lossless,
                                                               quality=70))
            if c[0] != b"VP8X"]


def _frame(chunks) -> bytes:
    return b"".join(fixtures._riff_chunk(k, p) for k, p in chunks)


@pytest.mark.parametrize("lossless", [True, False])
@pytest.mark.parametrize("case", [
    "exif flag", "exif no flag", "xmp flag", "xmp no flag", "metadata after image",
    "canvas mismatch", "unknown chunks", "trailing bytes", "trailing chunk", "truncated",
    "riff size past end", "alpha flag", "alpha no flag", "alph corrupt no flag",
    "alph corrupt flag"])
def test_container_equals_jax(lossless, case):
    """libwebp's demuxer rules as PIL meets them: EXIF and XMP chunks
    count only when the VP8X flags announce them, wherever they sit;
    the image must fill the canvas; unknown chunks are skipped; bytes
    that do not make a chunk, a truncated file and a RIFF size past the
    end are refused; an ALPH chunk is read only with the alpha flag."""
    image = _frame(_image_chunks(lossless, alpha=case.startswith("al")))
    if case.startswith("al") and lossless:
        image = _frame(_image_chunks(False, alpha=True))
    if case.startswith("alph corrupt"):
        chunks = _image_chunks(False, alpha=True)
        image = _frame([(b"ALPH", b"\xff" + chunks[0][1][1:]), chunks[1]])
    meta = fixtures._riff_chunk(b"EXIF", _EXIF) + fixtures._riff_chunk(b"XMP ", _XMP)
    body = {
        "exif flag": lambda: _vp8x(0x08, 33, 21) + meta + image,
        "exif no flag": lambda: _vp8x(0x04, 33, 21) + meta + image,
        "xmp flag": lambda: _vp8x(0x04, 33, 21) + fixtures._riff_chunk(b"XMP ", _XMP) + image,
        "xmp no flag": lambda: _vp8x(0x00, 33, 21) + fixtures._riff_chunk(b"XMP ", _XMP) + image,
        "metadata after image": lambda: _vp8x(0x0C, 33, 21) + image + meta,
        "canvas mismatch": lambda: _vp8x(0x00, 34, 21) + image,
        "unknown chunks": lambda: (_vp8x(0, 33, 21) + fixtures._riff_chunk(b"ABCD", b"123")
                                   + image + fixtures._riff_chunk(b"ZZZZ", b"")),
        "trailing bytes": lambda: image + b"abc",
        "trailing chunk": lambda: image + fixtures._riff_chunk(b"EXIF", _EXIF),
        "truncated": lambda: image,
        "riff size past end": lambda: image,
        "alpha flag": lambda: _vp8x(0x10, 33, 21) + image,
        "alpha no flag": lambda: _vp8x(0x00, 33, 21) + image,
        "alph corrupt no flag": lambda: _vp8x(0x00, 33, 21) + image,
        "alph corrupt flag": lambda: _vp8x(0x10, 33, 21) + image,
    }[case]()
    data = _riff(body)
    if case == "truncated":
        data = data[:-3]
    if case == "riff size past end":
        data = data[:4] + struct.pack("<I", len(data)) + data[8:]
    _same(data)


@pytest.mark.parametrize("at", [(0, 0), (4, 2), (16, 12)])
@pytest.mark.parametrize("first_lossy", [True, False])
def test_animation_first_frame_on_its_canvas(at, first_lossy):
    """An animation reads as its first frame drawn on a transparent black
    canvas at its offset (a key frame: never blended), as PIL reads it;
    a later frame outside the canvas, a missing ANIM chunk and an
    animation without frames are refused on both sides."""
    rng = np.random.default_rng(at[0] + first_lossy)
    lossy = rng.integers(0, 256, (8, 6, 4), dtype=np.uint8)
    lossless = rng.integers(0, 256, (10, 14, 3), dtype=np.uint8)
    if first_lossy:
        data = fixtures.webp_animation(lossy, lossless, (32, 24), at)
    else:
        data = fixtures.webp_animation(lossless, lossy, (32, 24), at, lossless_first=True)
    got = _same(data)
    frame = lossy if first_lossy else lossless
    outside = np.ones(got.shape[:2], bool)
    outside[at[1]:at[1] + frame.shape[0], at[0]:at[0] + frame.shape[1]] = False
    assert not got[outside].any()
    chunks = fixtures._riff_chunks(data)
    anim = [c for c in chunks if c[0] == b"ANMF"]
    vp8x = fixtures._riff_chunk(*chunks[0])
    _same(_riff(vp8x + _frame(anim)))  # no ANIM chunk
    _same(_riff(vp8x + fixtures._riff_chunk(b"ANIM", bytes(6))))  # no frames
    moved = bytearray(anim[1][1])
    moved[0:3] = (14).to_bytes(3, "little")  # x = 28: past the 32-wide canvas
    _same(_riff(vp8x + fixtures._riff_chunk(b"ANIM", bytes(6)) + _frame([anim[0]])
                + fixtures._riff_chunk(b"ANMF", bytes(moved))))


@pytest.mark.parametrize("name", ["exif_6.webp", "xmp_8.webp", "lossy.webp"])
def test_format_exif_data_equals_jax(name):
    """The web UI's EXIF summary of a WebP: the EXIF chunk's tags (PIL's
    WebPImageFile._getexif), None without one."""
    path = str(FIXTURES / name)
    assert pio.format_exif_data(path) == jax_format_exif(path)


def test_bitstream_faults_are_refused():
    """A lossless stream cut short, a lossy frame that is not a key
    frame, and a lossy first partition cut short: refused on both
    sides, naming WebP."""
    (kind, lossless), = [c for c in _image_chunks(True)]
    (_, lossy), = [c for c in _image_chunks(False)]
    for body in (fixtures._riff_chunk(b"VP8L", lossless[:len(lossless) // 2]),
                 fixtures._riff_chunk(b"VP8 ", bytes([lossy[0] | 1]) + lossy[1:]),
                 fixtures._riff_chunk(b"VP8 ", lossy[:14])):
        data = _riff(body)
        with pytest.raises(Exception):
            jax_decode(data)
        with pytest.raises(pio.ImageFormatError, match="WebP"):
            pio.decode_image(data)
