"""The port's synthetic-data harness (circuitvision_tpu_torch/eval/:
randomized, glyphs over the Aileron table, handdrawn, degrade, synth,
pool) against the JAX package's eval/ and scripts/gen_pool.py on the CPU,
byte for byte; its PIL replacements against PIL: the font table
(scripts/make_font_table.py's check), the JPEG encoder's bytes
(io/image_io.encode_jpeg), the PNG writer's eXIf orientation
(io/image_io.encode_png) and the letterbox resize
(ops/image.resize_pil_bilinear_u8).
"""
import dataclasses
import importlib.util
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from circuitvision_tpu.eval import degrade as jdegrade
from circuitvision_tpu.eval import glyphs as jglyphs
from circuitvision_tpu.eval import handdrawn as jhand
from circuitvision_tpu.eval import randomized as jrand
from circuitvision_tpu.eval import synth as jsynth
from circuitvision_tpu.io.image_io import load_image as jload_image
from circuitvision_tpu_torch.eval import aileron
from circuitvision_tpu_torch.eval import degrade as tdegrade
from circuitvision_tpu_torch.eval import glyphs as tglyphs
from circuitvision_tpu_torch.eval import handdrawn as thand
from circuitvision_tpu_torch.eval import pool as tpool
from circuitvision_tpu_torch.eval import randomized as trand
from circuitvision_tpu_torch.eval import synth as tsynth
from circuitvision_tpu_torch.io import image_io
from circuitvision_tpu_torch.ops.image import resize_pil_bilinear_u8

ROOT = Path(__file__).resolve().parents[1]
EVAL_IMAGES = sorted((ROOT / "eval_data" / "images").glob("*.png"))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _boxes(bs):
    return [tuple(getattr(b, f.name) for f in dataclasses.fields(b)) for b in bs]


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


# ------------------------------------------------------------- generators
@pytest.mark.parametrize("seed0", range(0, 200, 25))
def test_random_circuit_matches_jax(seed0):
    for seed in range(seed0, seed0 + 25):
        jm, jb = jrand.random_circuit(seed)
        tm, tb = trand.random_circuit(seed)
        _same(tm, jm, f"mask {seed}")
        assert _boxes(tb) == _boxes(jb), seed


@pytest.mark.parametrize("overrides", [False, True])
@pytest.mark.parametrize("seed", [3, 17, 101, 4242])
def test_render_schematic_matches_jax(seed, overrides):
    outs = []
    for rand, glyphs in ((jrand, jglyphs), (trand, tglyphs)):
        mask, boxes = rand.random_circuit(seed)
        kw = {}
        if overrides:
            uids = [b.persistent_uid for b in boxes]
            kw = dict(value_overrides={u: f"{i + 1}k" for i, u in enumerate(uids[::2])},
                      direction_overrides={u: "LEFT" for u in uids[1::3]})
        outs.append(glyphs.render_schematic(mask, boxes, np.random.default_rng(seed), **kw))
    (ji, jv, jd, jt), (ti, tv, td, tt) = outs
    _same(ti, ji, "image")
    assert (tv, td, _boxes(tt)) == (jv, jd, _boxes(jt))
    assert tt, "no value text printed"


@pytest.mark.parametrize("style", ["clean", "photo"])
@pytest.mark.parametrize("seed", [1, 7, 12, 100003])
def test_handdrawn_circuit_matches_jax(seed, style):
    j = jhand.handdrawn_circuit(seed, style=style)
    t = thand.handdrawn_circuit(seed, style=style)
    _same(t[0], j[0], "image")
    _same(t[1], j[1], "mask")
    assert _boxes(t[2]) == _boxes(j[2])
    assert (t[3], t[4], _boxes(t[5])) == (j[3], j[4], _boxes(j[5]))


@pytest.fixture(scope="module")
def circuits():
    return jsynth.make_all_circuits(), tsynth.make_all_circuits()


@pytest.mark.parametrize("i", range(63))
def test_make_all_circuits_matches_jax(circuits, i):
    jc, tc = circuits
    assert len(jc) == len(tc) == 63
    a, b = jc[i], tc[i]
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            _same(y, x, f"{a.name}.{f.name}")
        elif f.name == "boxes":
            assert _boxes(y) == _boxes(x), a.name
        else:
            assert y == x, (a.name, f.name)


@pytest.mark.parametrize("tier", sorted(jdegrade.DEGRADE_TIERS))
def test_degrade_tiers_match_jax(circuits, tier):
    jc, tc = circuits
    for k, seed in ((0, 0), (21, 5), (40, 77), (62, 1234)):
        j = jdegrade.degrade(jc[k].image, tier, seed, boxes=jc[k].boxes, mask=jc[k].wire_mask)
        t = tdegrade.degrade(tc[k].image, tier, seed, boxes=tc[k].boxes, mask=tc[k].wire_mask)
        _same(t[0], j[0], f"{tier} image")
        assert _boxes(t[1]) == _boxes(j[1])
        _same(t[2], j[2], f"{tier} mask")


@pytest.fixture(scope="module")
def gen_pool():
    return _script("gen_pool")


@pytest.mark.parametrize("seed0", [100000, 100020, 100040])
def test_render_item_matches_gen_pool(gen_pool, seed0):
    for seed in range(seed0, seed0 + 20):
        j = gen_pool.render_item(seed, 0.25, 0.40)
        t = tpool.render_item(seed, 0.25, 0.40)
        assert set(t) == set(j)
        for k in j:
            _same(t[k], j[k], f"{seed} {k}")


def test_write_and_load_pool_match_the_jax_scripts(gen_pool, tmp_path):
    """Three items written by the port, letterboxed by the port's
    load_pool and by scripts/train_detector.py:load_pool (PIL's resize);
    the port's cache read back."""
    tpool.write_pool(str(tmp_path / "p"), 3, seed0=100000, log_every=0)
    shutil.copytree(tmp_path / "p", tmp_path / "j")
    for i in range(3):
        with np.load(tmp_path / "p" / f"{i:06d}.npz") as z:
            ref = gen_pool.render_item(100000 + i, 0.25, 0.40)
            for k in ref:
                _same(z[k], ref[k], k)
    train_detector = _script("train_detector")
    jimg, jbox, jtier = train_detector.load_pool(str(tmp_path / "j"), 96)
    for _ in range(2):  # the letterbox, then the cache
        timg, tbox, ttier = tpool.load_pool(str(tmp_path / "p"), 96)
        _same(timg, jimg, "letterboxed")
        assert [[(b.class_name, b.xmin, b.ymin, b.xmax, b.ymax) for b in bs] for bs in tbox] == \
            [[(b.class_name, b.xmin, b.ymin, b.xmax, b.ymax) for b in bs] for bs in jbox]
        assert ttier == jtier


# ------------------------------------------------------- PIL replacements
@pytest.mark.parametrize("size", aileron.GLYPHS)
def test_font_table_matches_pil(size):
    """scripts/make_font_table.py's check at one size: every printable
    pair, random strings on random backgrounds clipped at the edges, and
    every string the harness prints."""
    mft = _script("make_font_table")
    assert mft.check(aileron.GLYPHS, n_random=150, sizes=(size,)) == []


def _pil_jpeg(a, q):
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="JPEG", quality=q)
    return buf.getvalue()


@pytest.mark.parametrize("quality", [12, 50, 75, 95])
def test_encode_jpeg_writes_pils_bytes(quality):
    rng = np.random.default_rng(quality)
    cases = [np.asarray(Image.open(p).convert("RGB")) for p in EVAL_IMAGES[::9]]
    cases += [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
              for h, w in ((1, 1), (9, 17), (17, 9), (560, 400))]
    for a in cases:
        assert image_io.encode_jpeg(a, quality) == _pil_jpeg(a, quality), a.shape


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), q=st.integers(1, 100),
       seed=st.integers(0, 2 ** 32 - 1), smooth=st.booleans())
def test_encode_jpeg_hypothesis_sweep(h, w, q, seed, smooth):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w, 3))
    if smooth:
        a = np.cumsum(rng.integers(-6, 7, (h, w, 3)), axis=1) + 128
    a = np.clip(a, 0, 255).astype(np.uint8)
    assert image_io.encode_jpeg(a, q) == _pil_jpeg(a, q)


@pytest.mark.parametrize("orientation", [None, 1, 3, 6, 8])
def test_encode_png_exif_orientation_read_by_pil_and_the_port(orientation, tmp_path):
    rng = np.random.default_rng(0)
    for a in (rng.integers(0, 256, (7, 11, 3)).astype(np.uint8),
              rng.integers(0, 256, (5, 3)).astype(np.uint8)):
        data = image_io.encode_png(a, exif_orientation=orientation)
        im = Image.open(io.BytesIO(data))
        _same(np.asarray(im), a, "PIL pixels")
        assert im.getexif().get(0x0112) == orientation
        if a.ndim == 3:
            path = tmp_path / "x.png"
            path.write_bytes(data)
            _same(image_io.load_image(str(path)), jload_image(str(path)), "port vs JAX load")


def test_write_eval_set_matches_jax_and_eval_data(circuits, tmp_path):
    """The port's eval set, decoded by the JAX package's load_image, equals
    the JAX package's written set and the checked-in eval_data/."""
    jc, tc = circuits
    jsynth.write_eval_set(str(tmp_path / "j"), jc)
    tsynth.write_eval_set(str(tmp_path / "t"), tc)
    for name in ("categories.json",):
        assert (tmp_path / "t" / name).read_text() == (ROOT / "eval_data" / name).read_text()
    for c in tc:
        for ref_root in (tmp_path / "j", ROOT / "eval_data"):
            img = f"images/{c.name}.png"
            _same(jload_image(str(tmp_path / "t" / img)), jload_image(str(ref_root / img)), img)
            m = f"masks/{c.name}.png"
            _same(np.asarray(Image.open(tmp_path / "t" / m)), np.asarray(Image.open(ref_root / m)),
                  m)
            for sub, ext in (("boxes", "json"), ("netlists", "cir"), ("labels", "json")):
                f = f"{sub}/{c.name}.{ext}"
                assert (tmp_path / "t" / f).read_text() == (ref_root / f).read_text(), f
        with open(tmp_path / "t" / "images" / f"{c.name}.png", "rb") as f:
            assert image_io.decode_image(f.read()).shape == c.image.shape


@pytest.mark.parametrize("hw", [(1100, 260), (900, 260), (300, 420), (640, 640), (17, 9),
                                (480, 801)])
def test_resize_pil_bilinear_matches_pil_at_letterbox_sizes(hw):
    rng = np.random.default_rng(hw[0])
    a = rng.integers(0, 256, (*hw, 3)).astype(np.uint8)
    h, w = hw
    for size in (640, 96):
        s = min(size / h, size / w)
        nh, nw = int(round(h * s)), int(round(w * s))
        ref = np.asarray(Image.fromarray(a).resize((nw, nh), Image.BILINEAR))
        _same(resize_pil_bilinear_u8(a, (nh, nw)), ref, f"{hw} → {(nh, nw)}")
    _same(resize_pil_bilinear_u8(a[..., 0], (h // 3 + 1, w * 2)),
          np.asarray(Image.fromarray(a[..., 0]).resize((w * 2, h // 3 + 1), Image.BILINEAR)),
          "grey, mixed")


def test_pool_digests_pin_the_jax_renders(gen_pool):
    """The sha256 of pool items as the JAX package renders them: the
    digests `chip_smoke.py` holds the card machine's renders to."""
    import hashlib

    sys.path.insert(0, str(ROOT))
    from chip_smoke import POOL_ITEM_DIGESTS, pool_item_digest

    for seed, digest in POOL_ITEM_DIGESTS.items():
        item = gen_pool.render_item(seed, 0.25, 0.40)
        assert pool_item_digest(item, hashlib) == digest, seed


def test_entry_points_run_on_the_cpu(tmp_path, monkeypatch):
    """scripts/torch_gen_pool.py, torch_train_detector.py,
    torch_train_reader.py and torch_make_eval_set.py at tiny sizes with
    --device cpu: the pool's items are gen_pool's, the detector resumes
    from its checkpoint, the eval set is the JAX package's."""
    monkeypatch.chdir(tmp_path)
    assert _script("torch_gen_pool").main(["--out", "pool", "--n", "4"]) == 0
    with np.load(tmp_path / "pool" / "000003.npz") as z:
        ref = _script("gen_pool").render_item(100003, 0.25, 0.40)
        for k in ref:
            _same(z[k], ref[k], k)
    det = _script("torch_train_detector")
    args = ["--pool", "pool", "--batch", "2", "--img-size", "64", "--scale", "n",
            "--warmup-steps", "1", "--val-n", "1", "--log-every", "1", "--eval-every", "0",
            "--save", "final", "--ckpt-dir", "run", "--save-every", "1", "--device", "cpu"]
    assert det.main(["--steps", "2", *args]) == 0
    assert det.main(["--steps", "3", *args]) == 0  # resumes from step 2
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == \
        ["step_00000002", "step_00000002.DONE", "step_00000003", "step_00000003.DONE"]
    assert _script("torch_train_reader").main(
        ["--steps", "2", "--batch", "8", "--train-circuits", "1", "--val-circuits", "1",
         "--log-every", "1", "--device", "cpu"]) == 0
    assert _script("torch_make_eval_set").main(["--out", "ev"]) == 0
    for name in ("netlists/golden.cir", "categories.json"):
        assert (tmp_path / "ev" / name).read_text() == (ROOT / "eval_data" / name).read_text()
