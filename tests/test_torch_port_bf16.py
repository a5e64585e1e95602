"""The port in bfloat16 against the JAX package in bfloat16: the plain
versions of all seven ported kernels against the Pallas kernels in
interpret mode (flash attention against the JAX einsum attention, its
flash path's reference), and one analyze() of the shipped checkpoints.

Kernel inputs are bf16 values on both sides. Tolerance on max |port −
jax|: two bf16 ulps at max |jax|, the card's rule for kernel against
plain version — the outputs round to bf16 once, and a stored bf16
intermediate (LN output, q/k/v, probabilities, hidden activation) that
rounds the other way after a last-bit difference in an f32 sum moves the
result by about one more ulp.
"""
import dataclasses
import math
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitvision_tpu.core.config import DetectorConfig as JDet
from circuitvision_tpu.core.config import PipelineConfig as JPipe
from circuitvision_tpu.core.config import sam2_hiera_preset
from circuitvision_tpu.models.checkpoint import load_model_checkpoint
from circuitvision_tpu.models.sam2 import hiera as jhiera
from circuitvision_tpu.ops.pallas.global_attn import attn_proj_residual as pallas_proj
from circuitvision_tpu.ops.pallas.global_attn import ln_qkv_flash as pallas_ln_qkv
from circuitvision_tpu.ops.pallas.mlp_block import mlp_block as pallas_mlp
from circuitvision_tpu.ops.pallas.refinement_fused import refinement_fused as pallas_refine
from circuitvision_tpu.ops.pallas.window_attn import qpool_attn_block as pallas_qpool
from circuitvision_tpu.ops.pallas.window_attn import window_attn_block as pallas_window
from circuitvision_tpu.pipeline.analyzer import CircuitAnalyzerTPU
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.ops.cuda import flash_attn as tflash
from circuitvision_tpu_torch.ops.cuda import global_attn as tglobal
from circuitvision_tpu_torch.ops.cuda import mlp_block as tmlp
from circuitvision_tpu_torch.ops.cuda import refinement as trefine
from circuitvision_tpu_torch.ops.cuda import window_attn as twin
from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch

ROOT = Path(__file__).resolve().parents[1]


def _bf(rng, *shape, scale=1.0):
    """float32 array of bf16 values."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _j(*arrays):
    return [jnp.asarray(a, jnp.bfloat16) for a in arrays]


def _tb(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16) for a in arrays]


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    ref_max = float(np.abs(ref).max())
    tol = 2.0 * 2.0 ** (math.floor(math.log2(max(ref_max, 2.0 ** -126))) - 7)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol, (np.abs(got - ref).max(), tol)


def _f(t):
    return t.float().numpy()


def test_mlp_block_bf16():
    rng = np.random.default_rng(0)
    t, c = 64, 96
    h = 4 * c
    x, lns, lnb = _bf(rng, t, c), 1 + _bf(rng, c, scale=0.1), _bf(rng, c, scale=0.1)
    w0, b0 = _bf(rng, c, h, scale=c ** -0.5), _bf(rng, h, scale=0.02)
    w1, b1 = _bf(rng, h, c, scale=h ** -0.5), _bf(rng, c, scale=0.02)
    ref = pallas_mlp(*_j(x, lns, lnb, w0, b0, w1, b1), row_tile=32, hidden_chunk=h // 2,
                     interpret=True)
    got = tmlp.mlp_block_plain(*_tb(x, lns, lnb, w0.T, b0, w1.T, b1))
    _close(_f(got), ref)


@pytest.mark.parametrize("wt,t,c,heads", [(4, 64, 96, 2), (8, 16, 48, 2)])
def test_window_attn_block_bf16(wt, t, c, heads):
    rng = np.random.default_rng(1)
    x, lns, lnb = _bf(rng, wt, t, c), 1 + _bf(rng, c, scale=0.1), _bf(rng, c, scale=0.1)
    wqkv, bqkv = _bf(rng, c, 3 * c, scale=c ** -0.5), _bf(rng, 3 * c, scale=0.02)
    wproj, bproj = _bf(rng, c, c, scale=c ** -0.5), _bf(rng, c, scale=0.02)
    ref = pallas_window(*_j(x, lns, lnb, wqkv, bqkv, wproj, bproj), heads=heads, gw=wt // 2,
                        interpret=True)
    args = _tb(x, lns, lnb, wqkv.T, bqkv, wproj.T, bproj)
    _close(_f(twin.window_attn_block_plain(*args, heads=heads)), ref)
    _close(_f(twin.window_attn_block_tiled(*args, heads=heads)), ref)


def test_qpool_attn_block_bf16():
    rng = np.random.default_rng(2)
    nw, win, ci, co, heads = 4, 8, 48, 96, 2
    rows = _bf(rng, nw * win * win, ci)
    lns, lnb = 1 + _bf(rng, ci, scale=0.1), _bf(rng, ci, scale=0.1)
    wsk, bsk = _bf(rng, ci, co, scale=ci ** -0.5), _bf(rng, co, scale=0.02)
    wqkv, bqkv = _bf(rng, ci, 3 * co, scale=ci ** -0.5), _bf(rng, 3 * co, scale=0.02)
    wpr, bpr = _bf(rng, co, co, scale=co ** -0.5), _bf(rng, co, scale=0.02)
    ref = pallas_qpool(*_j(rows, lns, lnb, wsk, bsk, wqkv, bqkv, wpr, bpr), heads=heads, win=win,
                       interpret=True)
    args = _tb(rows, lns, lnb, wsk.T, bsk, wqkv.T, bqkv, wpr.T, bpr)
    _close(_f(twin.qpool_attn_block_plain(*args, heads=heads, win=win)), ref)
    _close(_f(twin.qpool_attn_block_tiled(*args, heads=heads, win=win)), ref)


def test_refinement_bf16():
    """bf16 logits and weights in, float32 out on both sides."""
    rng = np.random.default_rng(3)
    x = _bf(rng, 1, 64, 96, 1, scale=3.0)
    ws = [_bf(rng, k, k, 1, 4, scale=1.0 / k) for k in trefine.KERNELS]
    bs = [_bf(rng, 4, scale=0.1) for _ in trefine.KERNELS]
    wc, bc = _bf(rng, 1, 1, 16, 1, scale=0.25), _bf(rng, 1, scale=0.1)
    ref = np.asarray(pallas_refine(*_j(x), tuple(_j(*ws)), tuple(_j(*bs)), *_j(wc, bc),
                                   tile_h=32, interpret=True))
    got = trefine.refinement_plain(*_tb(x), _tb(*(w.transpose(3, 2, 0, 1) for w in ws)),
                                   _tb(*bs), *_tb(wc.transpose(3, 2, 0, 1), bc))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


def test_ln_qkv_bf16():
    rng = np.random.default_rng(4)
    n, c, heads = 256, 576, 8
    hd = c // heads
    x, lns, lnb = _bf(rng, 1, n, c), 1 + _bf(rng, c, scale=0.1), _bf(rng, c, scale=0.1)
    w, b = _bf(rng, c, 3 * c, scale=c ** -0.5), _bf(rng, 3 * c, scale=0.02)
    ref = pallas_ln_qkv(*_j(x, lns, lnb, w, b), heads=heads, interpret=True)
    got = tglobal.ln_qkv_plain(*_tb(x, lns, lnb, w.T, b), heads)
    for r, g in zip(ref, got):
        _close(_f(g), np.asarray(r, np.float32)[..., :hd])


def test_attn_proj_residual_bf16():
    rng = np.random.default_rng(5)
    n, c, heads = 256, 576, 8
    hd = c // heads
    x, o = _bf(rng, 1, n, c), _bf(rng, 1, heads, n, hd)
    w, b = _bf(rng, c, c, scale=c ** -0.5), _bf(rng, c, scale=0.02)
    o_pad = np.pad(o, ((0, 0), (0, 0), (0, 0), (0, 128 - hd)))
    ref = pallas_proj(*_j(x, o_pad, w, b), interpret=True)
    _close(_f(tglobal.attn_proj_residual_plain(*_tb(x, o, w.T, b))), ref)


def test_flash_attn_bf16():
    """flash_attn's plain version against the JAX einsum attention in bf16
    at the global blocks' length (its flash path's reference)."""
    rng = np.random.default_rng(6)
    n, heads, hd = 4096, 2, 72
    q, k, v = (_bf(rng, 1, n, heads, hd) for _ in range(3))
    with jhiera.force_flash(False):
        ref = jhiera._flash_or_einsum_attention(*_j(q, k, v), hd)
    got = tflash.flash_attn_plain(*_tb(*(a.transpose(0, 2, 1, 3) for a in (q, k, v))))
    _close(_f(got).transpose(0, 2, 1, 3), ref)


def _rgb(path):
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


def _boxes(r):
    return sorted((b.class_name, b.xmin, b.ymin, b.xmax, b.ymax) for b in r.bboxes_orig_nms)


def _shipped_bf16():
    yv, ymeta = load_model_checkpoint(str(ROOT / "ckpt" / "yolo"))
    sv, smeta = load_model_checkpoint(str(ROOT / "ckpt" / "sam2"))
    yv, sv = jax.tree.map(np.asarray, yv), jax.tree.map(np.asarray, sv)
    d, s = ymeta["detector"], smeta["sam2"]
    jcfg = JPipe(detector=JDet(scale=d["scale"], img_size=d["img_size"],
                               num_classes=d["num_classes"], reg_max=d["reg_max"],
                               dtype="bfloat16"),
                 sam2=sam2_hiera_preset(s["preset"], dtype="bfloat16", **s["overrides"]))
    tcfg = tconfig.PipelineConfig(
        detector=dataclasses.replace(bridge.detector_config(ymeta), dtype="bfloat16"),
        sam2=bridge.sam2_config(smeta, dtype="bfloat16"))
    return yv, sv, jcfg, tcfg


def test_shipped_checkpoints_analyze_bf16():
    """ckpt/yolo (YOLOv11-s@640) + ckpt/sam2 (Hiera-t@512), both models in
    bfloat16 on both sides, on golden, loop and ac_rc. Both analyzers cast
    every parameter to bfloat16 (the JAX one through cast_float_params,
    the port through models/layers.place) and compute the norms, SiLU and
    head biases in XLA's order of roundings. What holds: the same boxes by
    class, each within one pixel, byte-equal on loop and ac_rc, the same
    node count and the same netlist text, and SAM2 masks that agree on at
    least 99.9 % of the pixels. What does not: golden's boxes are not
    byte-equal as in float32 — a ground box's edge moves by one pixel,
    because the convolutions sum in another order from YOLO's second
    layer on (test_bf16_first_diverging_layer)."""
    yv, sv, jcfg, tcfg = _shipped_bf16()
    ja = CircuitAnalyzerTPU(config=jcfg, yolo_variables=yv, sam2_variables=sv, vlm_client=None)
    ja.vlm_client = None
    ta = CircuitAnalyzerTorch(tcfg, bridge.state_dict_from_variables(yv),
                              bridge.state_dict_from_variables(sv), device="cpu")
    for name in ("golden", "loop", "ac_rc"):
        img = _rgb(ROOT / "eval_data" / "images" / f"{name}.png")
        ref, got = ja.analyze(img), ta.analyze(img)
        rb, gb = _boxes(ref), _boxes(got)
        assert [b[0] for b in gb] == [b[0] for b in rb], name
        assert max(abs(u - v) for g, r in zip(gb, rb) for u, v in zip(g[1:], r[1:])) <= 1, name
        if name != "golden":
            assert gb == rb, name
        assert len(got.nodes) == len(ref.nodes) and ref.nodes, name
        assert got.netlist_text == ref.netlist_text, name
        assert np.mean(got.sam_mask == ref.sam_mask) >= 0.999, name


def test_bf16_first_diverging_layer():
    """Where the bf16 packages part, on golden's letterboxed input through
    the shipped YOLO with the analyzers' bfloat16 parameters: the stem
    (convolution, BatchNorm, SiLU) is bit-equal to the JAX package's, so
    the BatchNorm's float32-rounded rsqrt and the SiLU's stepwise
    roundings are XLA's. The second layer's convolution is the first that
    differs, in a handful of its 1,638,400 values (2 when this was
    written), each by one bf16 ulp: oneDNN and XLA sum the 3×3×C products
    in other orders, and from there the differences spread."""
    import jax.numpy as jnp

    from circuitvision_tpu.models.initialization import cast_float_params
    from circuitvision_tpu.models.yolo.model import YOLOv11 as JYOLO
    from circuitvision_tpu.ops.image import letterbox as jletterbox
    from circuitvision_tpu_torch.models.layers import place
    from circuitvision_tpu_torch.models.yolo.model import YOLOv11 as TYOLO

    yv, _sv, jcfg, tcfg = _shipped_bf16()
    det = tcfg.detector
    img = _rgb(ROOT / "eval_data" / "images" / "golden.png")
    x = (np.asarray(jletterbox(jnp.asarray(img), det.img_size)[0])[None] / 255.0).astype(np.float32)
    jm = JYOLO(num_classes=det.num_classes, scale=det.scale, reg_max=det.reg_max,
               dtype=jnp.bfloat16)
    _, state = jm.apply(cast_float_params(yv, jnp.bfloat16), jnp.asarray(x),
                        capture_intermediates=True, mutable=["intermediates"])
    inter = state["intermediates"]

    def jax_out(path):
        node = inter
        for k in path.split("."):
            node = node[k]
        return np.asarray(node["__call__"][0], np.float32)

    tm = TYOLO(det.num_classes, det.scale, det.reg_max)
    tm.load_state_dict(bridge.state_dict_from_variables(yv))
    place(tm, "cpu", torch.bfloat16)
    got = {}
    names = ("b0.conv", "b0.bn", "b0", "b1.conv")
    for name in names:
        tm.get_submodule(name).register_forward_hook(
            lambda m, a, out, _n=name: got.__setitem__(_n, out.float().permute(0, 2, 3, 1).numpy()))
    with torch.no_grad():
        tm(torch.from_numpy(x))
    for name in names[:-1]:
        np.testing.assert_array_equal(got[name], jax_out(name), err_msg=name)
    ref = jax_out("b1.conv")
    diff = np.abs(got["b1.conv"] - ref)
    n = int((diff > 0).sum())
    assert 0 < n < 100, n
    # one ulp of the larger of the two values (they may straddle a power of two)
    big = np.maximum(np.abs(ref), np.abs(got["b1.conv"]))[diff > 0]
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(big, 2.0 ** -126))) - 7)
    assert (diff[diff > 0] <= ulp).all()
