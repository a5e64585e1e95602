"""The port's JPEG 2000 reader (circuitvision_tpu_torch/io/jpeg2000.py over
io/native/j2k.cpp, g++ at first use) against PIL 12.1.0 (OpenJPEG 2.5.4)
and the JAX package's decode_image and format_exif_data, which read
through PIL.

Every comparison is exact: the samples and mode PIL gives
(`np.asarray(Image.open(f))`, `.mode`), and the RGB array
`decode_image` gives, byte for byte, for the fixtures of
scripts/make_image_fixtures.py (`jpeg2000_kinds`, their digests in
eval_data/image_fixtures/digests.json — the 9/7 ones included: no sample
of any fixture or sweep case differs), for seeded sweeps of PIL-written
files and for SIZ rewrites at every precision from 1 to 16 bits, signed
and unsigned. What PIL's encoder cannot write raises ImageFormatError
naming it; a truncated file raises where PIL raises.
"""
import hashlib
import io
import json
import random
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from circuitvision_tpu.io.image_io import decode_image as jax_decode
from circuitvision_tpu.io.image_io import format_exif_data as jax_exif
from circuitvision_tpu_torch.io import image_io as pio
from circuitvision_tpu_torch.io import jpeg2000 as j2k

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "eval_data" / "image_fixtures"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
JPEG2000 = sorted(n for n in DIGESTS if n.endswith((".jp2", ".j2k")))


def _pil(data: bytes) -> Image.Image:
    im = Image.open(io.BytesIO(data))
    im.load()
    return im


def _save(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _same_as_pil(data: bytes) -> None:
    """Mode and samples as PIL gives them, and decode_image as the JAX
    package's."""
    ref = _pil(data)
    mode, samples, palette = j2k.read_jpeg2000(data)
    assert mode == ref.mode
    want = np.asarray(ref)
    assert samples.shape == want.shape and samples.dtype == want.dtype
    assert samples.tobytes() == want.tobytes()
    if mode in ("P", "PA"):
        assert palette[0] == list(ref.palette.colors)
    got = pio.decode_image(data)
    assert got.tobytes() == jax_decode(data).tobytes() and got.shape == jax_decode(data).shape


def test_the_fixtures_are_there():
    """jpeg2000_kinds wrote every kind the reader is held to (51 with
    digests, the truncated file without), under 600 KB together."""
    assert len(JPEG2000) == 51
    names = [p.name for p in FIXTURES.glob("jp2_*")]
    names += ["eval/degen_0.jp2", "eval/degen_0_97.jp2"]
    assert "jp2_truncated.jp2" in names and "jp2_truncated.jp2" not in DIGESTS
    size = sum((FIXTURES / n).stat().st_size for n in set(names))
    assert size < 600_000


@pytest.mark.parametrize("name", JPEG2000)
def test_fixture_equals_pil_and_its_digest(name):
    """Each fixture: PIL's mode and samples, decode_image's and load_image's
    RGB against the digest (what the card checks) and the JAX package's
    decode_image; format_exif_data None on both sides (PIL's
    Jpeg2KImageFile has no _getexif)."""
    path = FIXTURES / name
    data = path.read_bytes()
    _same_as_pil(data)
    got = pio.load_image(str(path))
    assert [list(got.shape), hashlib.sha256(got.tobytes()).hexdigest()] == \
        [DIGESTS[name]["shape"], DIGESTS[name]["sha256"]]
    assert not hasattr(Image.open(path), "_getexif")
    assert pio.format_exif_data(str(path)) is None and jax_exif(str(path)) is None


def test_truncated_file_raises_as_pil_does():
    data = (FIXTURES / "jp2_truncated.jp2").read_bytes()
    with pytest.raises(OSError):
        _pil(data)
    with pytest.raises(pio.ImageFormatError, match="JPEG 2000"):
        pio.decode_image(data)
    cs = _save(Image.new("RGB", (40, 30), (9, 99, 199)), no_jp2=True)
    for cut in (len(cs) - 1, len(cs) - 2, len(cs) * 2 // 3, 60):  # EOC, then tile data, SIZ
        with pytest.raises(OSError):
            _pil(cs[:cut])
        with pytest.raises(pio.ImageFormatError, match="JPEG 2000"):
            pio.decode_image(cs[:cut])


def _siz_geometry(data: bytes, **fields) -> bytes:
    """data (a codestream or JP2) with SIZ's Xsiz … YTOsiz replaced."""
    names = ("xsiz", "ysiz", "xo", "yo", "xt", "yt", "xto", "yto")
    at = data.index(J2K_SIZ) + 8  # SOC, SIZ, Lsiz, Rsiz
    values = dict(zip(names, struct.unpack(">8I", data[at:at + 32])))
    values.update(fields)
    return data[:at] + struct.pack(">8I", *(values[n] for n in names)) + data[at + 32:]


J2K_SIZ = b"\xff\x4f\xff\x51"
BOMB = dict(xsiz=40000, ysiz=40000, xt=40000, yt=40000)


@pytest.mark.parametrize("where", ["siz", "ihdr and siz", "ihdr"])
def test_decompression_bomb_raises_as_pil_does(where, monkeypatch):
    """A 24 x 20 file whose header says 40000 x 40000 (SIZ of a raw
    codestream, or a JP2's ihdr with or without its SIZ): PIL raises
    DecompressionBombError from Image.open, the port ImageFormatError
    from the header, decoding nothing."""
    im = Image.fromarray(np.arange(24 * 20 * 3, dtype=np.uint8).reshape(20, 24, 3))
    data = _save(im, no_jp2=where == "siz")
    if "siz" in where:
        data = _siz_geometry(data, **BOMB)
    if "ihdr" in where:
        at = data.index(b"ihdr") + 4
        data = data[:at] + struct.pack(">II", 40000, 40000) + data[at + 8:]
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    monkeypatch.setattr(j2k, "decode_codestream", lambda cs: pytest.fail("decoded"))
    with pytest.raises(pio.ImageFormatError, match="JPEG 2000.*decompression-bomb"):
        pio.decode_image(data)


def test_coordinates_past_2_31_raise_as_pil_does():
    """OpenJPEG keeps tile coordinates in 32-bit ints: a 24 x 20 image at
    offset 2^31 on the reference grid fails in PIL's load; the port
    refuses it from SIZ."""
    cs = _save(Image.new("L", (24, 20), 7), no_jp2=True)
    far = _siz_geometry(cs, xsiz=2 ** 31 + 24, xo=2 ** 31, xt=2 ** 31 + 24)
    with pytest.raises(OSError):
        _pil(far)
    with pytest.raises(pio.ImageFormatError, match="JPEG 2000.*2\\^31"):
        pio.decode_image(far)


def _cod_at(cs: bytes) -> int:
    return cs.index(b"\xff\x52", cs.index(b"\xff\x4f\xff\x51"))


def _with_style(style: int):
    def make(cs: bytes) -> bytes:
        at = _cod_at(cs) + 12  # the marker, Lcod, Scod, SGcod (4), NL, xcb, ycb
        return cs[:at] + bytes([style]) + cs[at + 1:]
    return make


def _after_cod(segment: bytes):
    def make(cs: bytes) -> bytes:
        at = _cod_at(cs)
        at += 2 + struct.unpack(">H", cs[at + 2:at + 4])[0]
        return cs[:at] + segment + cs[at:]
    return make


def _siz_byte(offset: int, value: int):
    def make(cs: bytes) -> bytes:
        at = cs.index(b"\xff\x51") + offset
        return cs[:at] + bytes([value]) + cs[at + 1:]
    return make


@pytest.mark.parametrize("make,name", [
    (_with_style(0x01), "BYPASS"), (_with_style(0x02), "RESET"), (_with_style(0x04), "TERMALL"),
    (_with_style(0x08), "VSC"), (_with_style(0x10), "PTERM"), (_with_style(0x20), "SEGSYM"),
    (_with_style(0x40), "HT"), (_with_style(0x05), "BYPASS, TERMALL"),
    (_after_cod(b"\xff\x5e\x00\x05\x00\x00\x02"), "RGN"),
    # a POC whose one progression (RPCL) is not the COD's (LRCP)
    (_after_cod(b"\xff\x5f\x00\x09\x00\x00\x00\x01\x04\x03\x02"), "POC"),
    (_siz_byte(41, 2), "subsampling"),
    (_siz_byte(4, 0x80), "Part 2"),
    (_after_cod(b"\xff\x74\x00\x04\x00\x00"), "Part 2"),
])
def test_what_pil_cannot_write_raises_naming_it(make, name):
    """Code-block styles, RGN, a POC that changes the order, component
    subsampling and Part 2 (Rsiz bit 15, its markers), patched into a
    PIL-written codestream (3 components, 3 resolutions)."""
    cs = _save(Image.fromarray(np.arange(24 * 20 * 3, dtype=np.uint8).reshape(20, 24, 3)),
               no_jp2=True, num_resolutions=3)
    with pytest.raises(pio.ImageFormatError, match=f"JPEG 2000.*{name}"):
        pio.decode_image(make(cs))


#: the options of the seeded sweeps; tiles and image offsets stay with the
#: fixtures (PIL's encoder crashes the process on some combinations of them)
_OPTIONS = [
    ("irreversible", [True]), ("progression", ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"]),
    ("num_resolutions", [1, 2, 3, 4, 5, 6]),
    ("codeblock_size", [(4, 4), (4, 64), (16, 8), (32, 32), (64, 64)]),
    ("precinct_size", [(16, 16), (32, 64), (64, 16), (128, 128)]),
    ("quality_layers", [[40], [20, 5], [30, 12, 3]]), ("mct", [1]), ("plt", [True]),
    ("no_jp2", [True]),
]


@pytest.mark.parametrize("seed", range(6))
def test_seeded_sweep_of_pil_written_files(seed):
    """Random sizes (odd ones included: partial code-blocks and
    precincts, one-sample bands), modes and options, eight files a seed."""
    rng = np.random.default_rng(seed)
    pick = random.Random(seed)
    for _ in range(8):
        h, w = pick.randint(1, 70), pick.randint(1, 70)
        mode = pick.choice(["L", "LA", "RGB", "RGBA", "I;16", "CMYK"])
        smooth = np.cumsum(rng.integers(-9, 10, (h, w, 4)), axis=1) % 256
        if mode == "I;16":
            im = Image.fromarray((smooth[..., 0] * 251 % 65536).astype(np.uint16))
        else:
            im = Image.fromarray(smooth.astype(np.uint8), "RGBA").convert(mode) \
                if mode != "CMYK" else Image.fromarray(smooth.astype(np.uint8), "CMYK")
        kw = {k: pick.choice(v) for k, v in _OPTIONS if pick.random() < 0.4}
        if "quality_layers" in kw:
            kw["quality_mode"] = "rates"
        try:
            data = _save(im, **kw)
        except OSError:  # the option set PIL's encoder refuses
            continue
        _same_as_pil(data)


@pytest.mark.parametrize("signed", [0, 1])
def test_every_precision_of_siz_as_pil_reads_it(signed):
    """A PIL-written grey codestream with SIZ's Ssiz rewritten to each
    precision from 1 to 16 bits: the data decode at that precision (DC
    shift, clamp), and PIL's unpackers take them to L (up to 8 bits;
    shifted up, or down with its rounding half) or I;16."""
    rng = np.random.default_rng(signed)
    grey = np.cumsum(rng.integers(-20, 21, (21, 23)), axis=1) % 256
    for irreversible in (False, True):
        cs = _save(Image.fromarray(grey.astype(np.uint8)), no_jp2=True, num_resolutions=3,
                   irreversible=irreversible)
        for bits in range(1, 17):
            data = _siz_byte(40, (signed << 7) | (bits - 1))(cs)
            _same_as_pil(data)


def _palette_jp2(entries, npc=3, alpha=False, colr=16, depth=7):
    rng = np.random.default_rng(4)
    idx = rng.integers(0, len(entries) + 2, (9, 13), dtype=np.uint8)
    im = Image.fromarray(np.stack([idx, idx * 3], -1), "LA") if alpha else Image.fromarray(idx)
    jp2 = _save(im)
    out, pos = jp2[:12], 12
    while pos < len(jp2):
        size, kind = struct.unpack(">I4s", jp2[pos:pos + 8])
        body = jp2[pos + 8:pos + size]
        if kind == b"jp2h":
            sub, at = b"", 0
            while at < len(body):
                s2, k2 = struct.unpack(">I4s", body[at:at + 8])
                b2 = body[at + 8:at + s2]
                if k2 == b"colr":
                    b2 = b2[:3] + struct.pack(">I", colr)
                sub += struct.pack(">I4s", 8 + len(b2), k2) + b2
                at += s2
            pclr = struct.pack(">HB", len(entries), npc) + bytes([depth] * npc) \
                + b"".join(bytes(e) for e in entries)
            cmap = b"".join(struct.pack(">HBB", 0, 1, i) for i in range(npc))
            for k2, b2 in ((b"pclr", pclr), (b"cmap", cmap)):
                sub += struct.pack(">I4s", 8 + len(b2), k2) + b2
            body = sub
        out += struct.pack(">I4s", 8 + len(body), kind) + body
        pos += size
    return out


@pytest.mark.parametrize("kw", [
    dict(entries=[(1, 2, 3), (4, 5, 6), (1, 2, 3), (7, 8, 9)]),
    dict(entries=[(1, 2, 3, 4), (5, 6, 7, 8)], npc=4),
    dict(entries=[(10, 20, 30), (40, 50, 60), (70, 80, 90)], alpha=True),
    dict(entries=[(1, 2, 3), (4, 5, 6)], colr=17),
    dict(entries=[(1, 2, 3), (4, 5, 6)], depth=15),
])
def test_palettes_as_pil_reads_them(kw):
    """pclr boxes on grey and grey+alpha: P and PA with ImagePalette's
    getcolor deduplication, an index past the palette black, an RGBA
    palette; a grey colr box or 16-bit entries, which PIL cannot read
    (no unpacker for the pair), raise on both sides."""
    data = _palette_jp2(**kw)
    try:
        _pil(data)
    except OSError:
        with pytest.raises(pio.ImageFormatError, match="JPEG 2000"):
            pio.decode_image(data)
        return
    _same_as_pil(data)


@pytest.mark.parametrize("enumcs", [0, 12, 14, 16, 17, 18, 24, 99])
def test_colour_spaces_as_pil_reads_them(enumcs):
    """colr enumerations over each component count: the unpacker PIL
    picks, or the refusal where it has none."""
    rng = np.random.default_rng(enumcs)
    for mode in ("L", "LA", "RGB", "RGBA"):
        im = Image.fromarray(rng.integers(0, 256, (7, 9, 4), dtype=np.uint8), "RGBA").convert(mode)
        jp2 = _save(im)
        at = jp2.index(b"colr") + 4
        data = jp2[:at + 3] + struct.pack(">I", enumcs) + jp2[at + 7:]
        try:
            _pil(data)
        except OSError:
            with pytest.raises(pio.ImageFormatError, match="JPEG 2000"):
                pio.decode_image(data)
            continue
        _same_as_pil(data)


def test_ycbcr_tables_equal_pil():
    """ycbcr_to_rgb against PIL's YCbCr → RGB on all 2^24 inputs."""
    y, cb, cr = np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij")
    ycc = np.stack([y, cb, cr], -1).astype(np.uint8).reshape(4096, 4096, 3)
    want = np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB"))
    assert np.array_equal(j2k.ycbcr_to_rgb(ycc), want)


def test_packet_spans_tile_the_codestream():
    """packet_spans, which the fixture writer rewrites packets by: every
    packet's header and body abut, and the packets of a tile-part fill its
    data."""
    cs = _save(Image.fromarray(np.zeros((33, 45, 3), np.uint8) + 77), no_jp2=True,
               quality_layers=[20, 5], quality_mode="rates", num_resolutions=3)
    spans = j2k.packet_spans(cs)
    assert (spans[:, 2] == spans[:, 3]).all() and (spans[1:, 1] == spans[:-1, 4]).all()
    assert spans[-1, 4] == len(cs) - 2  # then EOC
