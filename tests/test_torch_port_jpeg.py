"""The port's JPEG decoder (io/native/jpeg.cpp through io/image_io.py)
byte-equal to the JAX package's decode_image (PIL 12.1.0 on
libjpeg-turbo 3.1.3, then exif_transpose and convert("RGB")): every
JPEG fixture of scripts/make_image_fixtures.py, checked against its
committed digest too, and a seeded hypothesis sweep of sizes, qualities,
subsamplings (PIL's 4:4:4, 4:2:2, 4:2:0 and cv2's 4:4:0), progressive
scans, restart intervals and greyscale; progressive files cut after any
scan, which libjpeg decodes through block smoothing (the first nine AC
coefficients, and with no AC scan the DC, estimated from each block's
neighbours); and sweeps of what the reader took on later, written with
libjpeg's own encoder (scripts/image_fixture_writer.cpp): arithmetic
coding, CMYK and YCCK, sampling factors up to 4, and lossless frames,
with the kinds PIL refuses refused here too."""
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
    assert sum(n.startswith("eval/") and n.endswith(".jpg") for n in DIGESTS) == 16
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


def _sof_at(data: bytes) -> int:
    pos = 2
    while not (0xC0 <= data[pos + 1] <= 0xCF and data[pos + 1] not in (0xC4, 0xC8, 0xCC)):
        pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
    return pos


def test_other_sampling_factors_are_refused():
    """Sampling factors libjpeg does not take, which PIL refuses too: a
    ratio that does not divide (Cb 3x1 against Y 4x1: jdsample.c's
    JERR_FRACT_SAMPLE_NOTIMPL), a factor of 5, and more than 10 blocks
    in an MCU."""
    img = _content(np.random.default_rng(0), 16, 32, "noise")
    data = fixtures.jpeg_cv2(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)
    at = _sof_at(data) + 4 + 6  # the first component's id
    for offset, value, match in ((4, 0x31, "not an integral ratio"), (1, 0x51, "1 to 4"),
                                 (1, 0x43, "more than 10 blocks")):
        bad = bytearray(data)
        bad[at + offset] = value
        with pytest.raises(Exception):
            jax_decode(bytes(bad))
        with pytest.raises(pio.ImageFormatError, match=match):
            pio.decode_image(bytes(bad))


@pytest.fixture(scope="module")
def writer():
    """scripts/image_fixture_writer.cpp: libjpeg's own encoder, for the
    arithmetic-coded, YCCK and 4-to-1 files PIL cannot write."""
    return fixtures.Writer()


@settings(max_examples=40, derandomize=True, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 90),
       factors=st.sampled_from([(4, 1), (4, 2), (1, 4), (3, 1), (2, 4), (3, 2), (1, 3),
                                (2, 2, 2, 1), (4, 1, 2, 1), (1, 1, 2, 2)]),
       progressive=st.booleans(), arith=st.booleans(), restart=st.sampled_from([0, 3]),
       kind=st.sampled_from(["noise", "gradient", "lines"]), seed=st.integers(0, 2 ** 16))
def test_sampling_factors_up_to_4_equal_jax(writer, h, w, factors, progressive, arith, restart,
                                           kind, seed):
    """Luma (and, with four numbers, Cb) sampled up to 4 times the
    others: the fancy upsamplers where the ratio is 2, replication
    (int_upsample) elsewhere, as PIL decodes them."""
    img = _content(np.random.default_rng(seed), h, w, kind)
    f = list(factors) + [1] * (6 - len(factors))
    _equal(writer.jpeg(img, quality=85, arith=int(arith), progressive=int(progressive),
                       restart=restart, factors=f))


def test_cv2_411_equals_jax():
    img = _content(np.random.default_rng(0), 37, 53, "noise")
    _equal(fixtures.jpeg_cv2(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411))


@settings(max_examples=50, derandomize=True, deadline=None)
@given(h=st.integers(1, 80), w=st.integers(1, 90), quality=st.integers(1, 100),
       sampling=st.sampled_from([(1, 1), (2, 1), (1, 2), (2, 2)]), progressive=st.booleans(),
       restart=st.sampled_from([0, 1, 4]), space=st.sampled_from(["ycc", "rgb"]),
       kind=st.sampled_from(["noise", "gradient", "lines"]), seed=st.integers(0, 2 ** 16))
def test_arithmetic_sweep_equals_jax(writer, h, w, quality, sampling, progressive, restart,
                                     space, kind, seed):
    """Arithmetic coding (SOF9 sequential, SOF10 progressive: the Qe
    state machine, DC and AC conditioning, restarts), byte-equal to
    PIL."""
    img = _content(np.random.default_rng(seed), h, w, kind)
    _equal(writer.jpeg(img, space=space, quality=quality, arith=1, progressive=int(progressive),
                       restart=restart, factors=(*sampling, 1, 1, 1, 1)))


def _with_comments(data: bytes, total: int) -> bytes:
    """COM segments of `total` bytes in all right after SOI."""
    out = data[:2]
    while total > 0:
        n = min(total, 60000)
        out += b"\xff\xfe" + (n + 2).to_bytes(2, "big") + bytes(n)
        total -= n
    return out + data[2:]


def test_arithmetic_past_pils_block_raises_as_pil_does(writer):
    """Pillow hands libjpeg 65536 bytes at a time, and the arithmetic
    decoder cannot wait for more: a scan that needs bytes past the block
    in hand when it starts fails in PIL ("broken data stream") and raises
    here; one that does not is read on both sides, whatever the file's
    size (comment segments move a scan's start into the next block)."""
    rng = np.random.default_rng(3)
    small = rng.integers(0, 256, (200, 170, 3), dtype=np.uint8)
    large = rng.integers(0, 256, (200, 340, 3), dtype=np.uint8)
    cases = {"read": (small, 0), "raised": (large, 0), "read large": (small, 80000),
             "raised large": (small, 50000)}
    for progressive in (0, 1):
        for what, (img, pad) in cases.items():
            data = _with_comments(writer.jpeg(img, quality=97, arith=1, progressive=progressive),
                                  pad)
            assert (len(data) > 65536) == what.endswith("large") or what == "raised"
            if what.startswith("raised"):
                with pytest.raises(OSError):
                    jax_decode(data)
                with pytest.raises(pio.ImageFormatError, match="65536-byte block"):
                    pio.decode_image(data)
            else:
                _equal(data)


@settings(max_examples=40, derandomize=True, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 90), quality=st.integers(1, 100),
       space=st.sampled_from(["cmyk", "ycck", "pil"]),
       factors=st.sampled_from([(1, 1, 1, 1), (2, 2, 1, 1), (2, 1, 1, 1)]),
       progressive=st.booleans(), arith=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_cmyk_and_ycck_sweep_equal_jax(writer, h, w, quality, space, factors, progressive, arith,
                                       seed):
    """Four components: CMYK (PIL's Adobe files, libjpeg's) and YCCK
    (converted to CMYK as libjpeg does), read as PIL's inverted CMYK
    and converted to RGB."""
    rng = np.random.default_rng(seed)
    cmyk = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    if seed % 2:
        cmyk[..., :3] = 255 - _content(rng, h, w, "gradient")
    if space == "pil":
        buf = io.BytesIO()
        Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", quality=quality, progressive=progressive)
        data = buf.getvalue()
    else:
        f = (factors[0], factors[1], 1, 1, 1, 1, factors[2 if factors[0] == 1 else 0],
             factors[3 if factors[1] == 1 else 1])
        data = writer.jpeg(cmyk, space=space, quality=quality, arith=int(arith),
                           progressive=int(progressive), factors=f)
    _equal(data)


def test_cmyk_to_rgb_is_pils_conversion():
    """The probe that pins Pillow's CMYK -> RGB (per channel, from c and
    k): all 256 x 256 pairs through PIL, against the port's
    cmyk_to_rgb (which takes libjpeg's samples, inverted as PIL's CMYK;I
    raw mode reads them)."""
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    cmyk = np.stack([c, 255 - c, c // 2, k], axis=-1).astype(np.uint8)
    want = np.asarray(Image.fromarray(cmyk, "CMYK").convert("RGB"))
    assert np.array_equal(pio.cmyk_to_rgb(255 - cmyk), want)


@settings(max_examples=40, derandomize=True, deadline=None)
@given(h=st.integers(1, 24), w=st.integers(1, 30), predictor=st.integers(1, 7),
       pt=st.integers(0, 7), channels=st.sampled_from([1, 3, 4]),
       restart_rows=st.sampled_from([0, 1, 5]), seed=st.integers(0, 2 ** 16))
def test_lossless_sweep_equals_jax(h, w, predictor, pt, channels, restart_rows, seed):
    """Lossless (SOF3) frames written by scripts/make_image_fixtures.py:
    every predictor, point transform and restart interval, grey, RGB and
    CMYK."""
    img = np.random.default_rng(seed).integers(0, 256, (h, w, channels), dtype=np.uint8)
    _equal(fixtures.lossless_jpeg(img, predictor=predictor, pt=pt, restart_rows=restart_rows))


@settings(max_examples=40, derandomize=True, deadline=None)
@given(h=st.integers(1, 21), w=st.integers(1, 23), predictor=st.integers(1, 7),
       pt=st.integers(0, 3),
       factors=st.sampled_from([((2, 2), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1)),
                                ((1, 2), (1, 1), (1, 1)), ((2, 2), (2, 1), (1, 2)),
                                ((4, 1), (1, 1), (2, 1)), ((1, 1), (1, 1), (1, 1))]),
       seed=st.integers(0, 2 ** 16))
def test_lossless_subsampled_sweep_equals_jax(h, w, predictor, pt, factors, seed):
    """Lossless (SOF3) frames with subsampled components (the fixture
    script's lossless_jpeg_sampled; PIL's libjpeg-turbo upsamples them by
    replication and converts no colours): every predictor, point
    transforms, odd sizes whose MCUs run past the image. The first
    component has the largest factors, so it is h x w."""
    rng = np.random.default_rng(seed)
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    planes = [rng.integers(0, 256, (-(-h * fv // vmax), -(-w * fh // hmax)), dtype=np.uint8)
              for fh, fv in factors]
    _equal(fixtures.lossless_jpeg_sampled(planes, list(factors), predictor=predictor, pt=pt))
