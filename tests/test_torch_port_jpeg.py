"""The port's JPEG decoder (io/native/jpeg.cpp through io/image_io.py)
byte-equal to the JAX package's decode_image (PIL 12.1.0 on
libjpeg-turbo 3.1.3, then exif_transpose and convert("RGB")): every
JPEG fixture of scripts/make_image_fixtures.py, checked against its
committed digest too, and a seeded hypothesis sweep of sizes, qualities,
subsamplings (PIL's 4:4:4, 4:2:2, 4:2:0 and cv2's 4:4:0), progressive
scans, restart intervals and greyscale; and progressive files cut after
any scan, which libjpeg decodes through block smoothing (the first nine
AC coefficients, and with no AC scan the DC, estimated from each block's
neighbours)."""
import hashlib
import importlib.util
import io
import json
from pathlib import Path

import cv2
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


def _equal(data: bytes) -> np.ndarray:
    got, ref = pio.decode_image(data), jax_decode(data)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert got.tobytes() == ref.tobytes()
    return got


@pytest.mark.parametrize("name", sorted(n for n in DIGESTS if n.endswith(".jpg")))
def test_jpeg_fixtures_equal_jax_and_digest(name):
    data = (FIXTURES / name).read_bytes()
    entry = DIGESTS[name]
    got = _equal(data)
    assert list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]


def test_fixture_digests_are_what_pil_gives():
    """digests.json is PIL's decode of each committed file (the card has
    no PIL and checks the port against these)."""
    for name, entry in DIGESTS.items():
        arr = fixtures.pil_rgb((FIXTURES / name).read_bytes())
        assert [list(arr.shape), fixtures.digest(arr)] == [entry["shape"], entry["sha256"]]


def test_fixture_set_is_small_and_complete():
    """Every kind of file the fixture set is made to hold is there, under
    2 MB in all."""
    total = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file())
    assert total < 2_000_000
    for name in ("baseline_420", "baseline_422", "baseline_440", "baseline_444", "progressive",
                 "progressive_unrefined", "grey", "restart", "exif_3", "exif_6", "exif_8",
                 "adobe_rgb", "photo"):
        assert f"{name}.jpg" in DIGESTS
    assert sum(n.startswith("eval/") for n in DIGESTS) == 16
    assert DIGESTS["photo.jpg"]["shape"][0] * DIGESTS["photo.jpg"]["shape"][1] >= 3_000_000


def _content(rng: np.random.Generator, h: int, w: int, kind: str) -> np.ndarray:
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 // max(w - 1, 1)), (yy * 255 // max(h - 1, 1)),
                    ((xx + yy) * 7) % 256], axis=-1).astype(np.uint8)
    if kind == "lines":
        img[::5] = 0
        img[:, ::7] = 255
    return img


@settings(max_examples=80, derandomize=True, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70), quality=st.integers(1, 100),
       sampling=st.sampled_from(["444", "422", "420", "440"]), progressive=st.booleans(),
       restart=st.sampled_from([0, 1, 3]), grey=st.booleans(),
       kind=st.sampled_from(["noise", "gradient", "lines"]), seed=st.integers(0, 2 ** 16))
def test_jpeg_sweep_equals_jax(h, w, quality, sampling, progressive, restart, grey, kind, seed):
    img = _content(np.random.default_rng(seed), h, w, kind)
    if grey:
        img = np.repeat(np.asarray(Image.fromarray(img).convert("L"))[:, :, None], 3, axis=2)
    factor = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
              "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
              "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
              "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}[sampling]
    if grey or restart or sampling == "440":
        data = fixtures.jpeg_cv2(img, cv2.IMWRITE_JPEG_QUALITY, quality,
                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
                                 cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
                                 cv2.IMWRITE_JPEG_RST_INTERVAL, restart)
    else:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=quality, progressive=progressive,
                                  subsampling={"444": 0, "422": 1, "420": 2}[sampling])
        data = buf.getvalue()
    _equal(data)


def _scans(jpeg: bytes) -> list[tuple[int, int]]:
    """(start, end) of each scan: its SOS segment and entropy-coded data."""
    out, pos = [], 2
    while jpeg[pos + 1] != 0xD9:
        end = pos + 2 + int.from_bytes(jpeg[pos + 2:pos + 4], "big")
        if jpeg[pos + 1] == 0xDA:
            while not (jpeg[end] == 0xFF and jpeg[end + 1] != 0 and not 0xD0 <= jpeg[end + 1] <= 0xD7):
                end += 1
            out.append((pos, end))
        pos = end
    return out


@settings(max_examples=60, derandomize=True, deadline=None)
@given(h=st.integers(1, 60), w=st.integers(1, 60), quality=st.integers(5, 100),
       sampling=st.sampled_from(["444", "422", "420", "440"]), grey=st.booleans(),
       restart=st.sampled_from([0, 2]), cut=st.floats(0.0, 1.0), blur=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_progressive_cut_after_any_scan_equals_jax(h, w, quality, sampling, grey, restart, cut,
                                                  blur, seed):
    """A progressive file ended after its k-th scan — as a partial
    download leaves it, and the only way to leave coefficients short of
    full precision in a valid progression — byte-equal to PIL, through
    libjpeg's block smoothing (with DC interpolation where no AC scan
    came)."""
    img = _content(np.random.default_rng(seed), h, w, "noise")
    if blur:
        img = cv2.GaussianBlur(img, (5, 5), 2.0)
    factor = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
              "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
              "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
              "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}[sampling]
    src = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) if grey else img[..., ::-1]
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(src), [
        cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor, cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    data = enc.tobytes()
    scans = _scans(data)
    k = 1 + int(cut * (len(scans) - 1))
    _equal(data[:scans[k - 1][1]] + b"\xff\xd9")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientations_equal_jax(orientation):
    img = _content(np.random.default_rng(orientation), 9, 14, "noise")
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", exif=b"Exif\x00\x00" + fixtures.exif_blob(orientation))
    got = _equal(buf.getvalue())
    assert got.shape[:2] == ((14, 9) if orientation >= 5 else (9, 14))


def test_other_sampling_factors_are_refused():
    img = _content(np.random.default_rng(0), 16, 32, "noise")
    data = fixtures.jpeg_cv2(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)
    with pytest.raises(pio.ImageFormatError, match="sampling factors 4x1"):
        pio.decode_image(data)
