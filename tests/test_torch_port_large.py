"""SAM 2.1 Hiera-L@1024 in the port against the JAX package: the plain
versions of the global-attention kernels (`ln_qkv`, `flash_attn`,
`attn_proj_residual`) against the Pallas kernels in interpret mode and
the JAX einsum attention, the window-route table, the tiled routes of
the window and q-pool blocks, and the whole SAM2 forward at full L widths
and resolution 1024 with the depth cut to one block of every L shape
class.

Float32 on both sides, JAX at "highest" matmul precision. Tolerances:
1e-5 of the output's scale for the kernels' plain versions (sums of a
few hundred products in another order), and for the SAM2 logits
(seven blocks at widths up to 1152; about 1e-6 measured).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitvision_tpu.core.config import SAM2Config as JSAM2Config
from circuitvision_tpu.models.initialization import cast_float_params
from circuitvision_tpu.models.sam2 import hiera as jhiera
from circuitvision_tpu.models.sam2.wrapper import SAM2ImageSegmenter as JSAM2
from circuitvision_tpu.models.sam2.wrapper import init_params as jsam2_init
from circuitvision_tpu.ops.pallas.global_attn import attn_proj_residual as pallas_proj
from circuitvision_tpu.ops.pallas.global_attn import ln_qkv_flash as pallas_ln_qkv
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.models.layers import place
from circuitvision_tpu_torch.models.sam2 import hiera as thiera
from circuitvision_tpu_torch.models.sam2.wrapper import SAM2ImageSegmenter as TSAM2
from circuitvision_tpu_torch.ops.cuda import flash_attn as tflash
from circuitvision_tpu_torch.ops.cuda import global_attn as tglobal
from circuitvision_tpu_torch.ops.cuda import window_attn as twin

RTOL = 1e-5
#: Hiera-L@1024 cut to stages (1, 1, 3, 2): blocks 0 (one-block window,
#: 64 tokens × 144), 1 (q-pool 144→288 over shared memory, tiled),
#: 2 (one-block q-pool 288→576), 3 (256-token window, tiled), 4 (global,
#: 4096 tokens, flash route), 5 (16-window q-pool 576→1152, tiled),
#: 6 (1152-wide window, tiled)
L_CUT = dict(stages=(1, 1, 3, 2), global_att_blocks=(4,), dtype="float32")


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / max(1.0, np.abs(ref).max())


# -------------------------------------------------- (a) the shell kernels
def test_ln_qkv_plain_matches_pallas():
    rng = np.random.default_rng(0)
    n, c, heads = 256, 576, 8
    hd = c // heads
    x, lns, lnb = _arr(rng, 1, n, c), 1 + _arr(rng, c, scale=0.1), _arr(rng, c, scale=0.1)
    w, b = _arr(rng, c, 3 * c, scale=c ** -0.5), _arr(rng, 3 * c, scale=0.02)
    ref = pallas_ln_qkv(*map(jnp.asarray, (x, lns, lnb, w, b)), heads=heads, interpret=True)
    got = tglobal.ln_qkv_plain(*_t(x, lns, lnb, w.T, b), heads)
    assert got.shape == (3, 1, heads, n, hd)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert r.shape == (1, heads, n, 128)
        assert not r[..., hd:].any()  # the TPU's lane pad is exactly zero
        assert _rel(g.numpy(), r[..., :hd]) < RTOL


def test_attn_proj_residual_plain_matches_pallas():
    rng = np.random.default_rng(1)
    n, c, heads = 256, 576, 8
    hd = c // heads
    x, o = _arr(rng, 1, n, c), _arr(rng, 1, heads, n, hd)
    w, b = _arr(rng, c, c, scale=c ** -0.5), _arr(rng, c, scale=0.02)
    o_pad = np.pad(o, ((0, 0), (0, 0), (0, 0), (0, 128 - hd)))
    ref = np.asarray(pallas_proj(*map(jnp.asarray, (x, o_pad, w, b)), interpret=True))
    got = tglobal.attn_proj_residual_plain(*_t(x, o, w.T, b)).numpy()
    assert got.shape == ref.shape and _rel(got, ref) < RTOL


# ------------------------------------------------ (b) flash attention
def test_flash_plain_matches_jax_einsum_attention():
    """At the global blocks' sequence length: the JAX package's einsum
    attention (force_flash(False), its flash path's reference), (B, N, H,
    D) there, head-major here."""
    rng = np.random.default_rng(2)
    n, heads, hd = 4096, 2, 72
    q, k, v = (_arr(rng, 1, n, heads, hd) for _ in range(3))
    with jhiera.force_flash(False):
        ref = np.asarray(jhiera._flash_or_einsum_attention(*map(jnp.asarray, (q, k, v)), hd))
    got = tflash.flash_attn_plain(*_t(*(a.transpose(0, 2, 1, 3) for a in (q, k, v))))
    assert _rel(got.numpy().transpose(0, 2, 1, 3), ref) < RTOL


def test_flash_plain_pools_q_as_the_module_path():
    """pool_win: q is 2×2 max-pooled inside each window first, as the q-pool
    block's module path pools it (MultiScaleAttention q_pool)."""
    rng = np.random.default_rng(3)
    nw, heads, win, hd = 3, 2, 4, 8
    q, k, v = (_arr(rng, nw, heads, win * win, hd) for _ in range(3))
    pooled = np.asarray(jhiera._pool2x(jnp.asarray(
        q.reshape(nw * heads, win, win, hd)))).reshape(nw, heads, win * win // 4, hd)
    with jhiera.force_flash(False):
        ref = np.asarray(jhiera._flash_or_einsum_attention(
            *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (pooled, k, v)), hd))
    got = tflash.flash_attn_plain(*_t(q, k, v), pool_win=win).numpy()
    assert _rel(got.transpose(0, 2, 1, 3), ref) < RTOL


# --------------------------------------------------- (c) the window routes
def _kernel_blocks(cfg):
    """(kind, tokens, c_in, c_out) of every block that reaches the window
    or q-pool wrapper, walking the trunk as Hiera.forward does (a q-pool
    block keeps the previous stage's window; a window that does not
    divide the map takes the module path)."""
    stage_ends = np.cumsum(cfg.stages) - 1
    q_pool_blocks = set(stage_ends[:-1] + 1)
    side, dim, stage, shapes = cfg.resolution // 4, cfg.embed_dim, 0, set()
    for i in range(sum(cfg.stages)):
        window = cfg.window_spec[stage]
        if i in q_pool_blocks:
            stage += 1
        if i in cfg.global_att_blocks:
            window = 0
        fits = window and side % window == 0
        if i in q_pool_blocks:
            if fits and window % 2 == 0:
                shapes.add(("qpool", window * window, dim, 2 * dim))
            dim, side = 2 * dim, side // 2
        elif fits:
            shapes.add(("window", window * window, dim, dim))
    return shapes


#: (kind, tokens, c_in, c_out) → (shared-memory bytes in float32 and in
#: bfloat16, route in float32 and in bfloat16); the bf16 kernels own 64
#: (window) or 128 (q-pool) rows in bf16 (csrc/window_attn.cu
#: window_tc_smem, qpool_tc_smem); the float32 window and q-pool blocks'
#: largest block is their 3×TF32 GEMM's (csrc/tf32.cuh kGemmSmem)
ROUTES = {
    "t@512": {("window", 64, 96, 96): (55296, 71168, "block", "block"),
              ("qpool", 64, 96, 192): (55296, 153088, "block", "block"),
              ("window", 16, 192, 192): (55296, 138752, "block", "block"),
              ("qpool", 16, 192, 384): (55296, 179200, "block", "block")},
    "l@1024": {("window", 64, 144, 144): (55296, 104960, "block", "block"),
               ("qpool", 64, 144, 288): (55296, 172288, "block", "block"),
               ("window", 16, 288, 288): (55296, 206336, "block", "block"),
               ("qpool", 16, 288, 576): (55296, 217600, "block", "block"),
               ("window", 256, 576, 576): (55296, 409088, "tiled", "tiled"),
               ("qpool", 256, 576, 1152): (55296, 360960, "tiled", "tiled"),
               ("window", 64, 1152, 1152): (55296, 814592, "block", "tiled")},
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_window_route_at_every_block_shape(name, dtype):
    """Every window and q-pool block shape of the two configs, its
    shared-memory size in the dtype and its route in that dtype: the
    256-token windows do not fit the bf16 kernels' 64 rows, the 1152-wide
    window not the bf16 window kernel's shared memory; the float32 window
    block takes windows of 16 and 64 tokens at either config's head
    width, the 1152-wide one included, not 256, and the float32 q-pool
    block win 4 and 8, not win 16."""
    size, res = name.split("@")
    cfg = tconfig.sam2_hiera_preset(size, resolution=int(res))
    table = ROUTES[name]
    assert _kernel_blocks(cfg) == set(table)
    col = 0 if dtype == torch.float32 else 1
    hd = cfg.embed_dim // cfg.num_heads
    for shape, row in table.items():
        got = (twin.window_smem(*shape, dtype=dtype),
               twin.window_route(*shape, shape[3] // hd, dtype))
        assert got == (row[col], row[2 + col]), shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_routes_equal_the_plain_blocks(dtype):
    """The tiled routes, composed of the three kernels' plain versions,
    compute the one-block kernels' functions with the same roundings:
    equal in bfloat16 as in float32."""
    rng = np.random.default_rng(4)
    nw, win, ci, co, heads = 3, 8, 48, 96, 4
    t = win * win
    r = lambda *s, scale=1.0: torch.from_numpy(_arr(rng, *s, scale=scale)).to(dtype)  # noqa: E731
    wargs = (r(nw, t, co), 1 + r(co, scale=0.1), r(co, scale=0.1), r(3 * co, co, scale=co ** -0.5),
             r(3 * co, scale=0.02), r(co, co, scale=co ** -0.5), r(co, scale=0.02))
    torch.testing.assert_close(twin.window_attn_block_tiled(*wargs, heads=heads),
                               twin.window_attn_block_plain(*wargs, heads=heads), rtol=0, atol=0)
    qargs = (r(nw * t, ci), 1 + r(ci, scale=0.1), r(ci, scale=0.1), r(co, ci, scale=ci ** -0.5),
             r(co, scale=0.02), r(3 * co, ci, scale=ci ** -0.5), r(3 * co, scale=0.02),
             r(co, co, scale=co ** -0.5), r(co, scale=0.02))
    torch.testing.assert_close(twin.qpool_attn_block_tiled(*qargs, heads=heads, win=win),
                               twin.qpool_attn_block_plain(*qargs, heads=heads, win=win),
                               rtol=0, atol=0)


@pytest.mark.parametrize("hd,heads", [(60, 2), (20, 4), (136, 1)])
def test_tiled_routes_pad_head_widths_off_8(hd, heads):
    """In bfloat16 the tiled routes compute at heads padded to a multiple
    of 8 (pad_heads: zero q/k/v rows, the scale from the true width, zero
    projection columns, the output cut back) and give what the unpadded
    blocks give: the one-block plain versions, and for a global block the
    three plain kernels composed at the true width. The padding changes
    no value: zero products leave every sum as it was."""
    rng = np.random.default_rng(hd)
    dtype = torch.bfloat16
    nw, win, ci = 2, 4, 48
    co = hd * heads
    t = win * win
    r = lambda *s, scale=1.0: torch.from_numpy(_arr(rng, *s, scale=scale)).to(dtype)  # noqa: E731
    assert twin.padded_head_width(hd, dtype) % 8 == 0
    wargs = (r(nw, t, co), 1 + r(co, scale=0.1), r(co, scale=0.1), r(3 * co, co, scale=co ** -0.5),
             r(3 * co, scale=0.02), r(co, co, scale=co ** -0.5), r(co, scale=0.02))
    torch.testing.assert_close(twin.window_attn_block_tiled(*wargs, heads=heads),
                               twin.window_attn_block_plain(*wargs, heads=heads), rtol=0, atol=0)
    qargs = (r(nw * t, ci), 1 + r(ci, scale=0.1), r(ci, scale=0.1), r(co, ci, scale=ci ** -0.5),
             r(co, scale=0.02), r(3 * co, ci, scale=ci ** -0.5), r(3 * co, scale=0.02),
             r(co, co, scale=co ** -0.5), r(co, scale=0.02))
    torch.testing.assert_close(twin.qpool_attn_block_tiled(*qargs, heads=heads, win=win),
                               twin.qpool_attn_block_plain(*qargs, heads=heads, win=win),
                               rtol=0, atol=0)
    x, s_, b_, wqkv, bqkv, wproj, bproj = wargs
    q, k, v = tglobal.ln_qkv_plain(x, s_, b_, wqkv, bqkv, heads)
    ref = tglobal.attn_proj_residual_plain(x, tflash.flash_attn_plain(q, k, v), wproj, bproj)
    got = twin.window_attn_block_tiled(*wargs, heads=heads, round_proj=False)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_global_route_matches_module_block(monkeypatch):
    """A global block of at least FLASH_MIN_SEQ tokens takes ln_qkv →
    flash_attn → attn_proj_residual and gives the JAX block's output (its
    module path on the CPU); 1024 tokens (the t@512 global blocks) keep
    the module path."""
    rng = np.random.default_rng(6)
    c, heads = 64, 2
    jblk = jhiera.MultiScaleBlock(dim=c, dim_out=c, num_heads=heads)
    x = _arr(rng, 1, 64, 32, c)
    v = jax.tree.map(np.asarray, jblk.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    blk = thiera.MultiScaleBlock(c, c, heads, q_stride=False).eval()
    blk.load_state_dict(bridge.state_dict_from_variables(v), strict=True)
    calls = []
    monkeypatch.setattr(twin, "flash_attn",
                        lambda *a, **kw: calls.append(1) or tflash.flash_attn(*a, **kw))
    with torch.no_grad():
        blk(torch.from_numpy(x[:, :32]), 0, False)
        assert not calls
        got = blk(torch.from_numpy(x), 0, False).numpy()
    assert len(calls) == 1
    assert _rel(got, np.asarray(jblk.apply(v, jnp.asarray(x)))) < RTOL


# -------------------------------------------- (d) SAM2-L@1024, depth cut
@pytest.fixture(scope="module")
def l_pair():
    jm = JSAM2(cfg=JSAM2Config(**L_CUT))
    v = jax.tree.map(np.asarray, jsam2_init(jm, jax.random.PRNGKey(1)))
    tm = TSAM2(tconfig.SAM2Config(**L_CUT))
    tm.load_state_dict(bridge.state_dict_from_variables(v), strict=True)
    return jm, v, tm.eval()


def test_sam2_l1024_reduced_depth_matches(l_pair):
    jm, v, tm = l_pair
    x = np.random.default_rng(5).standard_normal((1, 1024, 1024, 3)).astype(np.float32)
    ref = [np.asarray(a) for a in jax.jit(jm.apply)(v, jnp.asarray(x))]
    with torch.no_grad():
        got = [a.numpy() for a in tm(torch.from_numpy(x))]
    for r, g in zip(ref, got):
        assert g.shape == r.shape and _rel(g, r) < RTOL
    hr_ref, hr_got = ref[0], got[0]
    tol = RTOL * max(1.0, np.abs(hr_ref).max())
    flipped = (hr_got > 0) != (hr_ref > 0)
    # a mask pixel may differ only where the logit is within the tolerance of 0
    assert not flipped.any() or np.abs(hr_ref[flipped]).max() <= tol


def test_bridge_carries_the_l_parameters(l_pair):
    """Every JAX L variable maps onto one port parameter of equal size,
    and seeded_state builds the full 48-block L@1024 weight set."""
    _jm, v, tm = l_pair
    sd = bridge.state_dict_from_variables(v)
    assert len(sd) == len(jax.tree_util.tree_leaves(v)) == len(tm.state_dict())
    full = bridge.seeded_state("sam2", {"sam2": {"preset": "l", "overrides": {}}}, seed=0)
    model = TSAM2(tconfig.SAM2Config())
    model.load_state_dict(full, strict=True)
    assert sum(1 for k in full if k.endswith("mlp_layers_0.weight")) == 48
    assert full["trunk.blocks_47.attn.qkv.weight"].shape == (3 * 1152, 1152)


# ------------------------------------- (e) head widths off the presets
#: a tiny Hiera with every path of t@512 (partitioned windows, q-pool
#: blocks, a global block on the module path), two heads a stage
def _tiny_hiera(hd, heads=2):
    return dict(embed_dim=heads * hd, num_heads=heads, stages=(1, 2, 3, 1),
                global_att_blocks=(4,), window_spec=(4, 2, 4, 2))


def _recording_paths(trunk):
    paths = []
    for i in range(trunk.depth):
        blk = getattr(trunk, f"blocks_{i}")
        blk.attention_path = (lambda x, w, p, _f=blk.attention_path:
                              paths.append(_f(x, w, p)) or paths[-1])
    return paths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,heads", [(32, 2), (64, 2), (60, 2), (60, 1), (136, 1)])
def test_hiera_at_off_preset_head_widths_matches_jax(hd, heads, dtype):
    """The port's Hiera at head widths the block kernels have no instance
    for, against the JAX trunk (its module path on the CPU) on the same
    variables and input, both in `dtype`. The blocks take the kernels'
    paths at every width (on the card in bf16: the tiled route and flash
    attention, at 60 with the heads padded to 64, at 136 on flash_attn's
    136 instance); here the kernels' plain versions run. With one head
    the first stage's width, 60, is off a multiple of 8 too (on the card
    those blocks run on rows padded to 64, `hiera.pad_block`). Tolerance:
    float32 1e-4 of max |jax| (summation order through seven blocks,
    ≈ 1e-6 measured); bfloat16 four bf16 ulps at max |jax| — the port
    rounds where the Pallas kernels do, the JAX module path where XLA
    does, and each block's output rounds once (≤ 2 ulps measured)."""
    got, ref, paths = _port_and_jax_trunks(hd, heads, dtype)
    kernels = ["window", "qpool", "window", "qpool", "module", "window", "qpool"]
    assert paths == kernels
    _assert_trunk_close(got, ref, dtype)


def _port_and_jax_trunks(hd, heads, dtype):
    """The port's and the JAX Hiera's outputs (float32 numpy) at head
    width hd on the same variables and input, both in `dtype`, and the
    attention paths the port's blocks took."""
    kw = _tiny_hiera(hd, heads)
    jdt = getattr(jnp, dtype)
    jm = jhiera.Hiera(**kw, dtype=jdt)
    x = np.random.default_rng(3).standard_normal((1, 128, 128, 3)).astype(np.float32)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = [np.asarray(a, np.float32)
           for a in jm.apply(cast_float_params(v, jdt) if dtype == "bfloat16" else v,
                             jnp.asarray(x))]
    tm = thiera.Hiera(**kw)
    tm.load_state_dict(bridge.state_dict_from_variables(v), strict=True)
    place(tm, "cpu", getattr(torch, dtype)).eval()
    paths = _recording_paths(tm)
    with torch.no_grad():
        got = [a.float().numpy() for a in tm(torch.from_numpy(x))]
    return got, ref, paths


def _assert_trunk_close(got, ref, dtype):
    for g, r in zip(got, ref):
        ref_max = float(np.abs(r).max())
        tol = 1e-4 * max(1.0, ref_max) if dtype == "float32" else \
            4.0 * 2.0 ** (np.floor(np.log2(ref_max)) - 7)
        assert g.shape == r.shape and np.abs(g - r).max() <= tol


def test_hiera_card_route_at_width_60_matches_jax_bf16(monkeypatch):
    """The card's route for a bf16 trunk of width 60 and one head, held
    against the JAX bf16 trunk: stage 1 and its transition (C = 60, off a
    multiple of 8) run in bf16 on rows zero-padded to 64 with each
    LayerNorm dividing by 60 (`pad_block`, forced here on the CPU tensors
    as the card takes it on CUDA ones; the plain versions stand in for
    the kernels), every later block unpadded. Held within the bf16 trunk
    tolerance of the test above, unchanged: four bf16 ulps at max |jax|
    (2.5 measured; the float32 detour this route replaced was held to the
    same)."""
    padded = []

    def card_gate(x, dim, dim_out):
        off = x.dtype == torch.bfloat16 and bool(dim % 8 or dim_out % 8)
        padded.append((dim, dim_out)) if off else None
        return off
    monkeypatch.setattr(thiera, "pad_block", card_gate)
    got, ref, _paths = _port_and_jax_trunks(60, 1, "bfloat16")
    assert padded == [(60, 60), (60, 120)]
    _assert_trunk_close(got, ref, "bfloat16")


@pytest.mark.parametrize("hd", [32, 64, 80, 128, 60, 136])
def test_hiera_head_width_gate(hd):
    """Which blocks of a Hiera-L@1024-shaped trunk (cut to one block a
    stage, head width hd in every stage) take a kernel path: the window
    and q-pool blocks at every width in both dtypes (a CUDA tensor at a
    width the kernels refuse raises in the wrapper), the global block up
    to MAX_HEAD_DIM, as before any width was routed. In bfloat16 the
    analyzer refuses, on the card, only a trunk whose heads, padded to a
    multiple of 8, are wider than flash_attn's widest instance (256);
    float32 refuses none."""
    for dtype in (torch.float32, torch.bfloat16):
        q = thiera.MultiScaleBlock(2 * hd, 4 * hd, 4, q_stride=True)
        g = thiera.MultiScaleBlock(8 * hd, 8 * hd, 8, q_stride=False)
        w = thiera.MultiScaleBlock(2 * hd, 2 * hd, 2, q_stride=False)
        x_q = torch.zeros(1, 16, 16, 2 * hd, dtype=dtype)
        x_g = torch.zeros(1, 64, 64, 8 * hd, dtype=dtype)
        x_w = torch.zeros(16, 8, 8, 2 * hd, dtype=dtype)
        assert q.attention_path(x_q, 8, False) == "qpool"
        assert g.attention_path(x_g, 0, False) == \
            ("global" if hd <= tflash.MAX_HEAD_DIM else "module")
        assert w.attention_path(x_w, 0, True) == "window"
    assert thiera.refused_head_width(2 * hd, 2) is None
    assert twin.padded_head_width(hd, torch.bfloat16) == -(-hd // 8) * 8
    assert twin.padded_head_width(hd, torch.float32) == hd


@pytest.mark.parametrize("dim,dim_out,q_stride", [(60, 60, False), (60, 120, True)])
def test_blocks_off_8_bytes_wide_run_float32_kernels(monkeypatch, dim, dim_out, q_stride):
    """A bf16 block whose width is off a multiple of 8 (embed 60, one
    head: stage 1 and its transition) no longer detours through float32
    on the card: it runs the bf16 kernels on rows zero-padded to 64
    (`pad_block`), forced here on the CPU. Its output is the unpadded
    bf16 block's within two bf16 ulps at max |ref| (the padded heads'
    zero columns change only the order of the products' sums); the padded
    parameters are zero past the true widths, padded once and again only
    after one is written; the gate itself is by dtype, device and
    width."""
    rng = np.random.default_rng(9)
    blk = thiera.MultiScaleBlock(dim, dim_out, dim_out // 60, q_stride=q_stride)
    with torch.no_grad():
        for p_ in blk.parameters():
            p_.copy_(torch.from_numpy(_arr(rng, *p_.shape, scale=0.1)))
    x = torch.from_numpy(_arr(rng, 2, 8, 8, dim)).to(torch.bfloat16)
    place(blk, "cpu", torch.bfloat16)
    with torch.no_grad():
        want = blk(x, 8, False)
        monkeypatch.setattr(thiera, "pad_block", lambda x, d, do: x.dtype == torch.bfloat16)
        got = blk(x, 8, False)
        pads = blk.padded_params()
        assert blk(x, 8, False).equal(got) and blk.padded_params() is pads  # padded once
        for name, t in pads.items():
            assert t.shape[-1] % 8 == 0 or name.startswith("attn.")
            own = blk.get_parameter(name)
            cut = t[tuple(slice(0, n) for n in own.shape)]
            assert cut.equal(own.float() if name.startswith("norm") else own)
            assert t.abs().sum().item() == cut.abs().sum().item()  # zero past the true widths
        blk.mlp_layers_1.bias.add_(1.0)  # a written parameter is padded again
        assert blk.padded_params() is not pads
        assert blk.padded_params()["mlp_layers_1.bias"][:dim_out].equal(blk.mlp_layers_1.bias)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    ulp = 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)
    assert (got.float() - want.float()).abs().max().item() <= 2 * ulp
    monkeypatch.undo()
    assert not thiera.pad_block(x, dim, dim_out)  # a CPU tensor: the plain versions
    assert not thiera.pad_block(x.float(), dim, dim_out)


@pytest.mark.parametrize("hd,heads", [(60, 2), (136, 1), (60, 1)])
def test_analyzer_refuses_bf16_head_widths_on_the_card(monkeypatch, hd, heads):
    """These bf16 head widths were refused on the card until the tiled
    route padded heads to a multiple of 8 and flash_attn gained a 136
    instance; now the analyzer builds its SAM2 (the card is only
    pretended here: the models are placed on the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    from circuitvision_tpu_torch.pipeline import analyzer as tanalyzer

    sam2 = dataclasses.replace(tconfig.SAM2Config(), embed_dim=heads * hd, num_heads=heads,
                               dtype="bfloat16", resolution=64, stages=(1, 1, 1, 1),
                               global_att_blocks=(2,),
                               backbone_channel_list=tuple(heads * hd * 2 ** i
                                                           for i in (3, 2, 1, 0)))
    cfg = dataclasses.replace(tconfig.PipelineConfig(), sam2=sam2,
                              detector=tconfig.DetectorConfig(scale="n", num_classes=64))
    assert thiera.refused_head_width(heads * hd, heads) is None
    ys = tanalyzer.YOLOv11(64, "n").state_dict()
    ss = tanalyzer.SAM2ImageSegmenter(sam2).state_dict()
    monkeypatch.setattr(tanalyzer, "place", lambda m, device, dtype: m)
    a = tanalyzer.CircuitAnalyzerTorch(cfg, ys, ss, device="cuda")
    assert a.sam2 is not None


@pytest.mark.parametrize("hd,heads", [(264, 1), (132, 1)])
def test_analyzer_refuses_bf16_heads_wider_than_the_kernels(monkeypatch, hd, heads):
    """Heads wider than flash_attn's widest bf16 instance (256) are
    refused before any model is built, naming the width. A trunk of width
    132, off a multiple of 8, was refused too while such blocks ran the
    float32 kernels (heads up to 128); it now runs the bf16 kernels on
    rows padded to 136 (`hiera.pad_block`), its heads on flash_attn's 136
    instance, and is not refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch
    from circuitvision_tpu_torch.ops.cuda.build import KernelError

    sam2 = dataclasses.replace(tconfig.SAM2Config(), embed_dim=heads * hd, num_heads=heads,
                               dtype="bfloat16")
    cfg = dataclasses.replace(tconfig.PipelineConfig(), sam2=sam2)
    if hd > tflash.TC_WIDTHS[-1]:
        assert thiera.refused_head_width(heads * hd, heads) == hd
        with pytest.raises(KernelError, match=f"is {hd}$"):
            CircuitAnalyzerTorch(cfg, {}, {}, device="cuda")
    else:
        assert thiera.refused_head_width(heads * hd, heads) is None
        # past the refusal the analyzer loads the (here empty) weights
        with pytest.raises(RuntimeError, match="Missing key"):
            CircuitAnalyzerTorch(cfg, {}, {}, device="cuda")
