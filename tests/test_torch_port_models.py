"""The port's YOLOv11 and SAM2 modules against the JAX package's, at tiny
configurations: the same seeded JAX variables go through
models/bridge.py into the port, the same numpy inputs through both.

Tolerances (float32 on both sides, JAX at "highest" matmul precision):
YOLO head outputs 1e-5 of their scale, SAM2 logits 1e-4 absolute (a
dozen blocks of products summed in another order); detections after NMS
must be identical.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitvision_tpu.core.config import SAM2Config as JSAM2Config
from circuitvision_tpu.models.sam2 import hiera as jhiera
from circuitvision_tpu.models.sam2.neck import FpnNeck as JNeck
from circuitvision_tpu.models.sam2.wrapper import SAM2ImageSegmenter as JSAM2
from circuitvision_tpu.models.sam2.wrapper import init_params as jsam2_init
from circuitvision_tpu.models.yolo import decode as jdecode
from circuitvision_tpu.models.yolo.model import YOLOv11 as JYOLO
from circuitvision_tpu.models.yolo.model import init_params as jyolo_init
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.models.sam2 import hiera as thiera
from circuitvision_tpu_torch.models.sam2.neck import FpnNeck as TNeck
from circuitvision_tpu_torch.models.sam2.wrapper import SAM2ImageSegmenter as TSAM2
from circuitvision_tpu_torch.models.yolo import decode as tdecode
from circuitvision_tpu_torch.models.yolo.model import YOLOv11 as TYOLO

ROOT = Path(__file__).resolve().parents[1]
#: SAM2 small enough for the CPU, with every trunk path of t@512: a
#: partitioned window block (0), q-pool kernel blocks (1, 3), a padded
#: window (6 over an 8² map, block 4), a global block (5), and a q-pool
#: block whose window does not divide the map (6)
TINY_SAM2 = dict(resolution=128, embed_dim=16, num_heads=1, stages=(1, 2, 3, 1),
                 global_att_blocks=(5,), window_spec=(4, 2, 6, 2),
                 backbone_channel_list=(128, 64, 32, 16), d_model=32, decoder_mlp_dim=64,
                 iou_head_hidden_dim=32, dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's tests, restored after: the
    suite runs six workers on eight cores, where torch's oversubscribed
    thread pools make these tests several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def yolo_pair():
    jm = JYOLO(num_classes=8, scale="n")
    v = jax.tree.map(np.asarray, jyolo_init(jm, jax.random.PRNGKey(0), img_size=128))
    tm = TYOLO(8, "n")
    tm.load_state_dict(bridge.state_dict_from_variables(v), strict=True)
    return jm, v, tm.eval()


@pytest.fixture(scope="module")
def sam2_pair():
    cfg = JSAM2Config(**TINY_SAM2)
    jm = JSAM2(cfg=cfg)
    v = jax.tree.map(np.asarray, jsam2_init(jm, jax.random.PRNGKey(1)))
    tm = TSAM2(tconfig.SAM2Config(**TINY_SAM2))
    tm.load_state_dict(bridge.state_dict_from_variables(v), strict=True)
    return jm, v, tm.eval()


def test_yolo_head_outputs_match(yolo_pair):
    jm, v, tm = yolo_pair
    x = np.random.default_rng(0).random((1, 128, 128, 3)).astype(np.float32)
    ref = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= 1e-5 * max(np.abs(r).max(), 1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_and_postprocess_identical(seed):
    """Heads with spread-out logits: boxes, scores, classes and the keep
    mask after class-aware NMS."""
    rng = np.random.default_rng(seed)
    outs = [rng.standard_normal((1, s, s, 64 + 8)).astype(np.float32) * 3 for s in (16, 8, 4)]
    jb, js = jdecode.decode_predictions([jnp.asarray(o) for o in outs], 16, 8)
    tb, ts = tdecode.decode_predictions([torch.from_numpy(o) for o in outs], 16, 8)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    det = jdecode.postprocess(jb, js, max_detections=32, conf_threshold=0.6, iou_threshold=0.5)
    got = tdecode.postprocess(torch.from_numpy(np.array(jb[0])), torch.from_numpy(np.array(js[0])),
                              max_detections=32, conf_threshold=0.6, iou_threshold=0.5)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(det.valid[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(det.classes[0]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(det.boxes[0]))
    mapped_j = np.asarray(jdecode.unletterbox_boxes(det.boxes[0], jnp.float32(0.64),
                                                    jnp.asarray([0.0, 80.0], jnp.float32), 1000, 750))
    mapped_t = tdecode.unletterbox_boxes(got[0], 0.64, (0.0, 80.0), 1000, 750).numpy()
    np.testing.assert_array_equal(mapped_t, mapped_j)


def test_sam2_segmenter_matches(sam2_pair):
    jm, v, tm = sam2_pair
    x = np.random.default_rng(2).standard_normal((1, 128, 128, 3)).astype(np.float32)
    hr, lr, iou = (np.asarray(a) for a in jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        thr, tlr, tiou = (a.numpy() for a in tm(torch.from_numpy(x)))
    assert thr.shape == hr.shape and tlr.shape == lr.shape
    assert np.abs(thr - hr).max() < 1e-4
    assert np.abs(tlr - lr).max() < 1e-4
    assert np.abs(tiou - iou).max() < 1e-5


def test_hiera_trunk_stage_outputs_match(sam2_pair):
    _jm, v, tm = sam2_pair
    cfg = TINY_SAM2
    trunk = jhiera.Hiera(embed_dim=cfg["embed_dim"], num_heads=cfg["num_heads"],
                         stages=cfg["stages"], global_att_blocks=cfg["global_att_blocks"],
                         window_spec=cfg["window_spec"])
    x = np.random.default_rng(3).standard_normal((1, 128, 128, 3)).astype(np.float32)
    ref = trunk.apply({"params": v["params"]["trunk"]}, jnp.asarray(x))
    with torch.no_grad():
        got = tm.trunk(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [tuple(r.shape) for r in ref]
    for r, g in zip(ref, got):
        assert np.abs(g.numpy() - np.asarray(r)).max() < 1e-4


def test_neck_matches():
    rng = np.random.default_rng(4)
    chans = (64, 32, 16, 8)
    xs = [rng.standard_normal((1, 32 // 2**i, 32 // 2**i, c)).astype(np.float32)
          for i, c in enumerate(reversed(chans))]
    jn = JNeck(d_model=16, backbone_channel_list=chans)
    v = jax.tree.map(np.asarray, jn.init(jax.random.PRNGKey(0), [jnp.asarray(a) for a in xs]))
    ref, _pos = jn.apply(v, [jnp.asarray(a) for a in xs])
    tn = TNeck(16, chans)
    tn.load_state_dict(bridge.state_dict_from_variables(v), strict=True)
    with torch.no_grad():
        got = tn([torch.from_numpy(a) for a in xs])
    for r, g in zip(ref, got):
        assert np.abs(g.numpy() - np.asarray(r)).max() < 1e-5


def test_bicubic_pos_embed_matches_torch_style_resize():
    """The port resizes the background pos-embed with F.interpolate
    bicubic, which the JAX package emulates (hiera.py:574)."""
    bkg = np.random.default_rng(5).standard_normal((1, 7, 7, 8)).astype(np.float32)
    ref = np.asarray(jhiera._torch_bicubic(jnp.asarray(bkg), (32, 24)))
    got = torch.nn.functional.interpolate(torch.from_numpy(bkg).permute(0, 3, 1, 2), (32, 24),
                                          mode="bicubic", align_corners=False)
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - ref).max() < 1e-5


@pytest.mark.parametrize("h,w,win", [(16, 16, 4), (8, 8, 6), (32, 32, 14)])
def test_window_partition_roundtrip_matches(h, w, win):
    x = np.random.default_rng(6).standard_normal((1, h, w, 3)).astype(np.float32)
    jw, jpad = jhiera.window_partition(jnp.asarray(x), win)
    tw, tpad = thiera.window_partition(torch.from_numpy(x), win)
    assert jpad == tpad
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    back = thiera.window_unpartition(tw, win, tpad, (h, w))
    np.testing.assert_array_equal(back.numpy(), x)


def test_bridge_maps_every_variable_once(sam2_pair, yolo_pair):
    for _jm, v, tm in (sam2_pair, yolo_pair):
        sd = bridge.state_dict_from_variables(v)
        n_leaves = len(jax.tree_util.tree_leaves(v))
        assert len(sd) == n_leaves == len(tm.state_dict())


@pytest.mark.parametrize("kind", ["yolo", "sam2"])
def test_seeded_state_loads_strict_at_shipped_shapes(kind):
    """seeded_state builds the full-size weight set the shipped meta.json
    names, and the port's model takes it with strict=True."""
    meta = json.loads((ROOT / "ckpt" / kind / "meta.json").read_text())
    state = bridge.seeded_state(kind, meta, seed=0)
    if kind == "yolo":
        cfg = bridge.detector_config(meta)
        model = TYOLO(cfg.num_classes, cfg.scale, cfg.reg_max)
        assert (cfg.scale, cfg.img_size, cfg.num_classes) == ("s", 640, 64)
    else:
        cfg = bridge.sam2_config(meta)
        model = TSAM2(cfg)
        assert (cfg.embed_dim, tuple(cfg.stages), cfg.resolution) == (96, (1, 2, 7, 2), 512)
    model.load_state_dict(state, strict=True)
    again = bridge.seeded_state(kind, meta, seed=0)
    assert all(torch.equal(state[k], again[k]) for k in state)
    assert all(torch.isfinite(t).all() for t in state.values())


def test_sam2_config_takes_the_checkpoint_dtype():
    """The SAM2 compute dtype is the checkpoint's (float32 for ckpt/sam2)
    unless the caller names one; a meta without it keeps the default."""
    meta = json.loads((ROOT / "ckpt" / "sam2" / "meta.json").read_text())
    assert meta["sam2_config"]["dtype"] == "float32"
    assert bridge.sam2_config(meta).dtype == "float32"
    assert bridge.sam2_config(meta, dtype="bfloat16").dtype == "bfloat16"
    assert bridge.sam2_config(meta).resolution == 512
    bare = {"sam2": {"preset": "l", "overrides": {}}}
    assert bridge.sam2_config(bare) == tconfig.SAM2Config()
    assert tconfig.SAM2Config().dtype == "bfloat16"


def test_l_preset_is_the_default_and_matches_jax():
    """sam2_hiera_preset("l") equals SAM2Config() and the JAX package's
    preset, field by field over the fields the port keeps."""
    from circuitvision_tpu.core.config import sam2_hiera_preset as jpreset

    port = tconfig.sam2_hiera_preset("l")
    assert port == tconfig.SAM2Config()
    jax_l = jpreset("l")
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(jax_l, f.name), f.name
