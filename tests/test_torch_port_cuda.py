"""The port's CUDA kernels on the card: each against its plain version
(the Hiera-L@1024 shapes of the global-attention kernels and the tiled
window routes among them), launch counting, operand checks, and a tiny
analyze() on the card against the CPU.

Marked `cuda`; every test skips where torch finds no CUDA device (the
check runs inside the fixture, never at import). On the card:
    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
Tolerance on max |kernel − plain|, by the dtype the kernel returns:
1e-4 · max(1, max |plain|) for float32 (summation order only); two bf16
ulps at max |plain| for bfloat16 (the output's own rounding, plus one
stored intermediate that rounds the other way).
"""
import math

import numpy as np
import pytest
import torch

from circuitvision_tpu_torch.ops.cuda import build
from circuitvision_tpu_torch.ops.cuda import flash_attn as fa
from circuitvision_tpu_torch.ops.cuda import fused_ln as fl
from circuitvision_tpu_torch.ops.cuda import global_attn as ga
from circuitvision_tpu_torch.ops.cuda import mlp_block as mb
from circuitvision_tpu_torch.ops.cuda import morphology as mo
from circuitvision_tpu_torch.ops.cuda import refinement as rf
from circuitvision_tpu_torch.ops.cuda import window_attn as wa

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, dt, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dt)


def _close(got, ref):
    """The tolerance follows the dtype the kernel returns (the refinement
    head returns float32 for any input dtype)."""
    out_dtype = got.dtype
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    ref_max = ref.abs().max().item()
    if out_dtype == torch.float32:
        tol = 1e-4 * max(1.0, ref_max)
    else:
        tol = 2.0 * 2.0 ** (math.floor(math.log2(max(ref_max, 2.0 ** -126))) - 7)
    assert (got - ref).abs().max().item() <= tol


DTYPES = [torch.float32, torch.bfloat16]
#: LayerNorm scale and bias are float32 for either dtype, as flax keeps them
F32 = torch.float32


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("t,c", [(100, 96), (16, 768), (65536, 144), (16384, 288), (4096, 576),
                                 (1024, 1152), (1000, 144), (300, 576), (70, 1152)])
def test_mlp_block_kernel(gen, dt, t, c):
    """Every Hiera-L@1024 width; T off the 64- and 128-row tiles; T small
    enough for the float32 kernel's hidden split and the bf16 GEMMs'
    smallest tiles."""
    args = (_rnd(gen, dt, t, c), 1 + _rnd(gen, F32, c, scale=0.1), _rnd(gen, F32, c, scale=0.1),
            _rnd(gen, dt, 4 * c, c, scale=c ** -0.5), _rnd(gen, dt, 4 * c, scale=0.02),
            _rnd(gen, dt, c, 4 * c, scale=(4 * c) ** -0.5), _rnd(gen, dt, c, scale=0.02))
    before = mb.mlp_block.launches
    _close(mb.mlp_block(*args), mb.mlp_block_plain(*args))
    assert mb.mlp_block.launches == before + 1


@pytest.mark.parametrize("t,c", [(16384, 96), (4096, 192), (1024, 384), (256, 768), (1001, 192),
                                 (37, 33)])
def test_mlp_block_f32_tensor_core_shapes(gen, t, c):
    """The float32 kernel (3×TF32 on the tensor cores) at Hiera-t@512's
    four shapes, the trained product's, whole — their depth splits
    included — a ragged T, and an odd width (4-byte copies, single
    stores); one launch counted per call."""
    dt = torch.float32
    args = (_rnd(gen, dt, t, c), 1 + _rnd(gen, F32, c, scale=0.1), _rnd(gen, F32, c, scale=0.1),
            _rnd(gen, dt, 4 * c, c, scale=c ** -0.5), _rnd(gen, dt, 4 * c, scale=0.02),
            _rnd(gen, dt, c, 4 * c, scale=(4 * c) ** -0.5), _rnd(gen, dt, c, scale=0.02))
    before = mb.mlp_block.launches
    _close(mb.mlp_block(*args), mb.mlp_block_plain(*args))
    assert mb.mlp_block.launches == before + 1


@pytest.mark.parametrize("nw,win,ci,co,heads", [(256, 8, 96, 192, 2), (256, 4, 192, 384, 4),
                                                (7, 4, 192, 384, 4), (3, 8, 144, 288, 4),
                                                (5, 4, 112, 224, 4)])
def test_qpool_attn_f32_tensor_core_shapes(gen, nw, win, ci, co, heads):
    """The float32 q-pool block (3×TF32) at Hiera-t@512's two transitions
    whole, at win 4 with a window count that leaves the last 64-row
    attention tile part empty, and at head widths 72 and 56; the block
    route, one launch counted per call and no tiled call."""
    dt = torch.float32
    args = (_rnd(gen, dt, nw * win * win, ci), 1 + _rnd(gen, F32, ci, scale=0.1),
            _rnd(gen, F32, ci, scale=0.1), _rnd(gen, dt, co, ci, scale=ci ** -0.5),
            _rnd(gen, dt, co, scale=0.02), _rnd(gen, dt, 3 * co, ci, scale=ci ** -0.5),
            _rnd(gen, dt, 3 * co, scale=0.02), _rnd(gen, dt, co, co, scale=co ** -0.5),
            _rnd(gen, dt, co, scale=0.02))
    assert wa.window_route("qpool", win * win, ci, co, heads, dt) == "block"
    before, tiled = wa.qpool_attn_block.launches, wa.qpool_attn_block.tiled
    _close(wa.qpool_attn_block(*args, heads=heads, win=win),
           wa.qpool_attn_block_plain(*args, heads=heads, win=win))
    assert wa.qpool_attn_block.launches == before + 1
    assert wa.qpool_attn_block.tiled == tiled


def test_f32_plans_match_kernel_smem(gen):
    """The float32 GEMM's shared memory (that of the float32 window and
    q-pool blocks' largest block, as window_smem gives it) and their
    attention blocks' are the kernels' own."""
    lib = build.library("window_attn")
    for win, ci, co in [(8, 96, 192), (4, 192, 384)]:
        assert lib.cv_qpool_attn_smem(win, ci, co, 0) == \
            wa.window_smem("qpool", win * win, ci, co, torch.float32) == mb.F32_GEMM_SMEM
    for t, c in [(64, 96), (16, 192)]:
        assert lib.cv_window_attn_smem(t, c, 0) == \
            wa.window_smem("window", t, c, c, torch.float32) == mb.F32_GEMM_SMEM
    for hd in wa.TC_HEAD_WIDTHS:
        assert lib.cv_qpool_f32_attn_smem(hd) == wa.qpool_attn_f32_smem(hd)
        assert lib.cv_window_f32_attn_smem(hd) == wa.window_attn_f32_smem(hd)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("nw,t,c,heads", [(8, 64, 96, 1), (8, 16, 192, 2), (32, 64, 144, 2),
                                          (64, 16, 288, 4), (5, 32, 112, 2), (7, 16, 288, 4)])
def test_window_attn_kernel(gen, dt, nw, t, c, heads):
    """The t@512 and Hiera-L@1024 one-block shapes with fewer windows (head
    widths 96 and 72), a 32-token window of head width 56 and window
    counts that leave the last 64-row block part empty (in float32 the
    attention kernel's 64-row blocks, and at (7, 16, 288, 4) both GEMMs'
    depth split); one launch counted per call, no tiled call."""
    before, tiled = wa.window_attn_block.launches, wa.window_attn_block.tiled
    args = (_rnd(gen, dt, nw, t, c), 1 + _rnd(gen, F32, c, scale=0.1), _rnd(gen, F32, c, scale=0.1),
            _rnd(gen, dt, 3 * c, c, scale=c ** -0.5), _rnd(gen, dt, 3 * c, scale=0.02),
            _rnd(gen, dt, c, c, scale=c ** -0.5), _rnd(gen, dt, c, scale=0.02))
    _close(wa.window_attn_block(*args, heads=heads), wa.window_attn_block_plain(*args, heads=heads))
    assert wa.window_attn_block.launches == before + 1
    assert wa.window_attn_block.tiled == tiled


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("nw,win,ci,co,heads", [(8, 8, 96, 192, 2), (8, 4, 192, 384, 4),
                                                (12, 4, 288, 576, 8), (7, 4, 288, 576, 8),
                                                (3, 8, 144, 288, 4)])
def test_qpool_attn_kernel(gen, dt, nw, win, ci, co, heads):
    """The t@512 shapes and the Hiera-L@1024 64-row shapes (win 4 288 →
    576 with 8 heads, win 8 144 → 288 with 4) with fewer windows, and at
    win 4 a window count that leaves the last 64-row block part empty."""
    args = (_rnd(gen, dt, nw * win * win, ci), 1 + _rnd(gen, F32, ci, scale=0.1),
            _rnd(gen, F32, ci, scale=0.1), _rnd(gen, dt, co, ci, scale=ci ** -0.5),
            _rnd(gen, dt, co, scale=0.02), _rnd(gen, dt, 3 * co, ci, scale=ci ** -0.5),
            _rnd(gen, dt, 3 * co, scale=0.02), _rnd(gen, dt, co, co, scale=co ** -0.5),
            _rnd(gen, dt, co, scale=0.02))
    block = wa.window_route("qpool", win * win, ci, co, heads, dt) == "block"
    before = wa.qpool_attn_block.launches
    _close(wa.qpool_attn_block(*args, heads=heads, win=win),
           wa.qpool_attn_block_plain(*args, heads=heads, win=win))
    assert wa.qpool_attn_block.launches == before + block


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,n,ci,co,heads,slabs", [(1, 4096, 576, 576, 8, 3),
                                                  (16, 64, 1152, 1152, 16, 3),
                                                  (64, 64, 144, 288, 1, 1),
                                                  (4, 256, 576, 576, 8, 3),
                                                  (64, 64, 144, 288, 4, 3),
                                                  (2, 256, 576, 1152, 16, 3),
                                                  (2, 256, 576, 1152, 1, 1),
                                                  (3, 100, 144, 288, 4, 3)])
def test_ln_qkv_kernel(gen, dt, b, n, ci, co, heads, slabs):
    """Every Hiera-L@1024 shape class with fewer windows — the global
    block, the stage-3 and stage-4 windows, both tiled q-pool transitions
    (q/k/v and the one-slab shortcut) — and rows off the GEMM's tiles."""
    args = (_rnd(gen, dt, b, n, ci), 1 + _rnd(gen, F32, ci, scale=0.1), _rnd(gen, F32, ci, scale=0.1),
            _rnd(gen, dt, slabs * co, ci, scale=ci ** -0.5), _rnd(gen, dt, slabs * co, scale=0.02))
    before = ga.ln_qkv.launches
    got = ga.ln_qkv(*args, heads, slabs)
    assert got.shape == (slabs, b, heads, n, co // heads)
    _close(got, ga.ln_qkv_plain(*args, heads, slabs))
    assert ga.ln_qkv.launches == before + 1


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,h,nq,nk,pool_win,d", [
    (1, 8, 4096, 4096, 0, 72), (16, 8, 256, 256, 0, 72), (16, 16, 256, 256, 16, 72),
    (64, 4, 64, 64, 8, 72), (64, 4, 16, 64, 0, 72), (2, 2, 100, 70, 0, 72),
    (3, 2, 17, 257, 0, 72), (4, 4, 100, 70, 0, 64), (2, 3, 17, 257, 0, 128),
    (4, 4, 100, 70, 0, 128), (16, 4, 64, 64, 8, 64), (2, 2, 33, 65, 0, 56),
    (16, 8, 256, 200, 0, 64), (20, 8, 300, 130, 0, 72)])
def test_flash_attn_kernel(gen, dt, b, h, nq, nk, pool_win, d):
    """Nq (rows after the pool) of 16 — one problem per warp, four a
    block — 17, 33, 64, 100, and 256, 300, 4096 in 128-row tiles; Nk on
    and off the 64-key tile; head widths 64, 72 and 128, and 56 on the
    64-wide instance; both q-pool window sides."""
    q, k, v = _rnd(gen, dt, b, h, nq, d), _rnd(gen, dt, b, h, nk, d), _rnd(gen, dt, b, h, nk, d)
    before = fa.flash_attn.launches
    _close(fa.flash_attn(q, k, v, pool_win), fa.flash_attn_plain(q, k, v, pool_win))
    assert fa.flash_attn.launches == before + 1


@pytest.mark.parametrize("b,h,nq,nk,pool_win,d,scale_width", [
    (2, 2, 100, 70, 0, 136, None), (2, 1, 33, 300, 0, 256, None), (16, 4, 64, 64, 8, 136, None),
    (4, 2, 100, 70, 0, 64, 60), (16, 2, 64, 64, 8, 136, 130)])
def test_flash_attn_wide_heads_and_true_width_scale(gen, b, h, nq, nk, pool_win, d, scale_width):
    """bf16 heads wider than 128 (the 136 and 256 instances) and padded
    heads whose softmax scale comes from their true width."""
    dt = torch.bfloat16
    q, k, v = _rnd(gen, dt, b, h, nq, d), _rnd(gen, dt, b, h, nk, d), _rnd(gen, dt, b, h, nk, d)
    _close(fa.flash_attn(q, k, v, pool_win, scale_width),
           fa.flash_attn_plain(q, k, v, pool_win, scale_width))


@pytest.mark.parametrize("hd,heads", [(60, 2), (20, 4), (136, 1)])
def test_padded_head_routes(gen, hd, heads):
    """bf16 window and q-pool blocks at head widths the tiled route pads
    (60, 20) or runs on a wide flash instance (136): the wrapper routes
    them to the tiled route, which agrees with the plain block."""
    dt, win, ci, co = torch.bfloat16, 8, 96, hd * heads
    t = win * win
    wargs = (_rnd(gen, dt, 4, t, co), 1 + _rnd(gen, F32, co, scale=0.1),
             _rnd(gen, F32, co, scale=0.1), _rnd(gen, dt, 3 * co, co, scale=co ** -0.5),
             _rnd(gen, dt, 3 * co, scale=0.02), _rnd(gen, dt, co, co, scale=co ** -0.5),
             _rnd(gen, dt, co, scale=0.02))
    before = wa.window_attn_block.tiled
    _close(wa.window_attn_block(*wargs, heads=heads),
           wa.window_attn_block_plain(*wargs, heads=heads))
    assert wa.window_attn_block.tiled == before + 1
    qargs = (_rnd(gen, dt, 4 * t, ci), 1 + _rnd(gen, F32, ci, scale=0.1),
             _rnd(gen, F32, ci, scale=0.1), _rnd(gen, dt, co, ci, scale=ci ** -0.5),
             _rnd(gen, dt, co, scale=0.02), _rnd(gen, dt, 3 * co, ci, scale=ci ** -0.5),
             _rnd(gen, dt, 3 * co, scale=0.02), _rnd(gen, dt, co, co, scale=co ** -0.5),
             _rnd(gen, dt, co, scale=0.02))
    _close(wa.qpool_attn_block(*qargs, heads=heads, win=win),
           wa.qpool_attn_block_plain(*qargs, heads=heads, win=win))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,n,c,heads,pool_win,round_proj", [(1, 4096, 576, 8, 0, False),
                                                             (16, 256, 576, 8, 0, True),
                                                             (16, 64, 1152, 16, 16, True),
                                                             (64, 16, 288, 4, 8, True),
                                                             (4, 256, 576, 8, 0, False),
                                                             (3, 100, 576, 8, 0, True),
                                                             (8, 64, 384, 4, 0, False),
                                                             (16, 16, 384, 4, 8, True),
                                                             (4, 256, 640, 8, 0, False),
                                                             (16, 16, 512, 4, 8, True),
                                                             (3, 100, 320, 10, 0, True)])
def test_attn_proj_residual_kernel(gen, dt, b, n, c, heads, pool_win, round_proj):
    """The Hiera-L@1024 shapes with fewer windows; 1024 rows at C = 576,
    which the bf16 plan gives 64-row blocks; rows off the GEMM's tiles;
    head width 96 (Hiera-t/-s) with and without the pooled residual; and
    head widths 80, 128 and 32, which the bf16 kernel reads through its
    runtime-width layout."""
    rows = pool_win * pool_win if pool_win else n
    args = (_rnd(gen, dt, b, rows, c), _rnd(gen, dt, b, heads, n, c // heads),
            _rnd(gen, dt, c, c, scale=c ** -0.5), _rnd(gen, dt, c, scale=0.02))
    kw = dict(pool_win=pool_win, round_proj=round_proj)
    if (b, n, c) == (4, 256, 576):
        assert ga.proj_res_plan(b * n, c).bm == 64
    before = ga.attn_proj_residual.launches
    _close(ga.attn_proj_residual(*args, **kw), ga.attn_proj_residual_plain(*args, **kw))
    assert ga.attn_proj_residual.launches == before + 1


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("nw,t,c,heads", [(16, 256, 576, 8), (16, 64, 1152, 16), (64, 64, 144, 2),
                                          (8, 64, 128, 2), (8, 16, 128, 4)])
def test_window_attn_tiled_route(gen, dt, nw, t, c, heads):
    """Where a window does not fit one block, or its head width (64, 32)
    has no block instance in either dtype, the wrapper takes the tiled
    route; where it does, the tiled route computes the same function."""
    args = (_rnd(gen, dt, nw, t, c), 1 + _rnd(gen, F32, c, scale=0.1), _rnd(gen, F32, c, scale=0.1),
            _rnd(gen, dt, 3 * c, c, scale=c ** -0.5), _rnd(gen, dt, 3 * c, scale=0.02),
            _rnd(gen, dt, c, c, scale=c ** -0.5), _rnd(gen, dt, c, scale=0.02))
    ref = wa.window_attn_block_plain(*args, heads=heads)
    tiled = wa.window_route("window", t, c, c, heads, dt) == "tiled"
    before = (wa.window_attn_block.tiled, wa.window_attn_block.launches)
    _close(wa.window_attn_block(*args, heads=heads), ref)
    assert (wa.window_attn_block.tiled, wa.window_attn_block.launches) == \
        (before[0] + tiled, before[1] + (not tiled))
    _close(wa.window_attn_block_tiled(*args, heads=heads), ref)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("nw,win,ci,co,heads", [(64, 8, 144, 288, 4), (16, 16, 576, 1152, 16),
                                                (64, 4, 288, 576, 8)])
def test_qpool_attn_tiled_route(gen, dt, nw, win, ci, co, heads):
    t = win * win
    args = (_rnd(gen, dt, nw * t, ci), 1 + _rnd(gen, F32, ci, scale=0.1),
            _rnd(gen, F32, ci, scale=0.1), _rnd(gen, dt, co, ci, scale=ci ** -0.5),
            _rnd(gen, dt, co, scale=0.02), _rnd(gen, dt, 3 * co, ci, scale=ci ** -0.5),
            _rnd(gen, dt, 3 * co, scale=0.02), _rnd(gen, dt, co, co, scale=co ** -0.5),
            _rnd(gen, dt, co, scale=0.02))
    ref = wa.qpool_attn_block_plain(*args, heads=heads, win=win)
    tiled = wa.window_route("qpool", t, ci, co, heads, dt) == "tiled"
    before = wa.qpool_attn_block.tiled
    _close(wa.qpool_attn_block(*args, heads=heads, win=win), ref)
    assert wa.qpool_attn_block.tiled == before + tiled
    _close(wa.qpool_attn_block_tiled(*args, heads=heads, win=win), ref)


def test_launch_plans_match_kernel_smem(gen):
    """The wrappers' shared-memory sizes are the kernels' own."""
    lib = build.library("flash_attn")
    for width in fa.TC_WIDTHS:
        for mt, wpp in ((1, 1), (1, 2), (1, 4), (2, 4)):
            for stages in (1, 2):
                assert lib.cv_flash_attn_bf16_smem(width, mt, wpp, stages) == \
                    fa.flash_tc_smem(width, mt, wpp, stages)
    lib = build.library("mlp_block")
    for bm in mb.GEMM_ROWS:
        assert lib.cv_mlp_gemm_smem(bm) == mb.gemm_smem(bm)
    for c in (96, 144, 192, 288, 384, 576, 768, 1152):
        assert lib.cv_mlp_ln_smem(c) == mb.ln_smem(c)
    lib = build.library("global_attn")
    for bm in mb.GEMM_ROWS:
        assert lib.cv_ln_heads_gemm_smem(bm) == mb.gemm_smem(bm)
    for c in (144, 288, 576, 1152):
        assert lib.cv_ln_heads_ln_smem(c) == ga.ln_qkv_plan(64, c, 3 * c).ln_smem
        # attn_proj_residual's bf16 GEMM is the same kernel
        plan = ga.proj_res_plan(4096, c)
        assert lib.cv_ln_heads_gemm_smem(plan.bm) == plan.smem


@pytest.mark.parametrize("dt", DTYPES)
def test_window_route_matches_kernel_smem(gen, dt):
    lib = build.library("window_attn")
    code = build.dtype_code(torch.empty(0, dtype=dt))
    for t, c in [(64, 96), (16, 192), (64, 144), (16, 288), (256, 576), (64, 1152)]:
        assert lib.cv_window_attn_smem(t, c, code) == wa.window_smem("window", t, c, c, dt)
    for win, ci, co in [(8, 96, 192), (4, 192, 384), (8, 144, 288), (4, 288, 576), (16, 576, 1152)]:
        assert lib.cv_qpool_attn_smem(win, ci, co, code) == \
            wa.window_smem("qpool", win * win, ci, co, dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_refinement_kernel(gen, dt):
    args = (_rnd(gen, dt, 2, 70, 130, 1, scale=3.0),
            [_rnd(gen, dt, 4, 1, k, k, scale=1.0 / k) for k in rf.KERNELS],
            [_rnd(gen, dt, 4, scale=0.1) for _ in rf.KERNELS],
            _rnd(gen, dt, 1, 16, 1, 1, scale=0.25), _rnd(gen, dt, 1, scale=0.1))
    _close(rf.refinement(*args), rf.refinement_plain(*args))


def test_kernels_refuse_mixed_dtypes(gen):
    x = _rnd(gen, torch.float32, 16, 32)
    bad = [_rnd(gen, torch.bfloat16, 32)] * 2
    with pytest.raises(build.KernelError):
        mb.mlp_block(x, *bad, _rnd(gen, torch.float32, 128, 32), _rnd(gen, torch.float32, 128),
                     _rnd(gen, torch.float32, 32, 128), _rnd(gen, torch.float32, 32))
    # LayerNorm parameters in the compute dtype are refused too: they are float32
    xb = x.to(torch.bfloat16)
    with pytest.raises(build.KernelError):
        fl.fused_layernorm(xb, *bad)


@pytest.mark.parametrize("h,w", [(600, 800), (600, 1003), (97, 130), (5, 3), (7, 5), (1, 1),
                                 (49, 53), (600, 1)])
def test_enhance_lines_fused_kernel_bit_exact(gen, h, w):
    """Line rasters and grey-level noise: kernel and plain version agree
    bit for bit (same taps, same order of rounded products and sums), at
    the drawings' rasters, at sizes below one 52 × 48 tile, one tile and
    a pixel past it, and one column."""
    noise = torch.round(torch.rand(h, w, generator=gen, device="cuda") * 255)
    lines = (torch.rand(h, w, generator=gen, device="cuda") < 0.05).float() * 255
    for x in (noise, lines):
        before = mo.enhance_lines_fused.launches
        assert torch.equal(mo.enhance_lines_fused(x), mo.enhance_lines_fused_plain(x))
        assert mo.enhance_lines_fused.launches == before + 1


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("t,c", [(65536, 144), (16384, 288), (4096, 576), (1024, 1152), (101, 96)])
def test_fused_layernorm_kernels(gen, dt, t, c):
    a, b = _rnd(gen, dt, t, c, scale=2.0), _rnd(gen, dt, t, c)
    s, bias = 1 + _rnd(gen, F32, c, scale=0.1), _rnd(gen, F32, c, scale=0.1)
    _close(fl.fused_layernorm(a, s, bias), fl.fused_layernorm_plain(a, s, bias))
    (r, y), (rp, yp) = fl.fused_add_layernorm(a, b, s, bias), fl.fused_add_layernorm_plain(a, b, s, bias)
    assert torch.equal(r, rp)
    _close(y, yp)


def test_trunk_layernorm_fused_launches(gen):
    from circuitvision_tpu_torch.models.sam2.hiera import TrunkLayerNorm

    m = TrunkLayerNorm(96, fused=True).cuda()
    x, r = _rnd(gen, torch.bfloat16, 2, 8, 8, 96), _rnd(gen, torch.bfloat16, 2, 8, 8, 96)
    before = (fl.fused_layernorm.launches, fl.fused_add_layernorm.launches)
    with torch.no_grad():  # the module's parameters require grad; the kernels have no backward
        y = m(x)
        resid, y2 = m(x, residual=r)
        assert (fl.fused_layernorm.launches, fl.fused_add_layernorm.launches) == \
            (before[0] + 1, before[1] + 1)
        m.fused = False
        _close(y, m(x))
        ref_resid, ref_y = m(x, residual=r)
    assert torch.equal(resid, ref_resid)
    _close(y2, ref_y)


def test_tiny_analyze_on_card_matches_cpu(gen):
    from circuitvision_tpu_torch.core.config import DetectorConfig, PipelineConfig
    from circuitvision_tpu_torch.models.bridge import sam2_config, seeded_state
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch

    ymeta = {"detector": {"scale": "n", "img_size": 128, "num_classes": 64, "reg_max": 16}}
    smeta = {"sam2": {"preset": "t", "overrides": {"resolution": 128}}}
    cfg = PipelineConfig(detector=DetectorConfig(scale="n", img_size=128, num_classes=64,
                                                 dtype="float32"),
                         sam2=sam2_config(smeta, dtype="float32"))
    ys, ss = seeded_state("yolo", ymeta, 0), seeded_state("sam2", smeta, 1)
    img = np.full((150, 200, 3), 255, np.uint8)
    img[50:53, 10:190] = 0
    img[100:103, 10:190] = 0
    card = CircuitAnalyzerTorch(cfg, ys, ss, device="cuda").analyze(img)
    cpu = CircuitAnalyzerTorch(cfg, ys, ss, device="cpu").analyze(img)
    key = lambda r: [(b.class_name, b.xmin, b.ymin, b.xmax, b.ymax) for b in r.bboxes_orig_nms]  # noqa: E731
    assert key(card) == key(cpu)
    assert card.netlist_text == cpu.netlist_text
    assert np.mean(card.sam_mask == cpu.sam_mask) > 0.999


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,h,w", [(1, 512, 512), (1, 1024, 1024), (2, 97, 131), (1, 1, 1),
                                   (1, 33, 9)])
def test_refinement_kernel_shapes(gen, dt, b, h, w):
    """The t@512 and L@1024 logit maps, a batch of two at a size off the
    32 × 32 tile and the 8-pixel strip (width not a multiple of 4: scalar
    stores), and maps smaller than a tile. Tolerance as for the whole
    head: the kernel returns float32."""
    args = (_rnd(gen, dt, b, h, w, 1, scale=3.0),
            [_rnd(gen, dt, 4, 1, k, k, scale=1.0 / k) for k in rf.KERNELS],
            [_rnd(gen, dt, 4, scale=0.1) for _ in rf.KERNELS],
            _rnd(gen, dt, 1, 16, 1, 1, scale=0.25), _rnd(gen, dt, 1, scale=0.1))
    before = rf.refinement.launches
    _close(rf.refinement(*args), rf.refinement_plain(*args))
    assert rf.refinement.launches == before + 1


@pytest.mark.parametrize("hd", [32, 64])
def test_off_preset_head_widths_route_and_match(gen, hd):
    """bf16 Hiera blocks at head widths the block kernels have no
    instance for: the window block (64 and 16 tokens) and the q-pool
    transition (win 8 and 4) take the tiled route — ln_qkv, flash_attn,
    attn_proj_residual with its runtime-width layout — and the global
    block's three kernels run at that width; each against its plain
    version."""
    dt = torch.bfloat16
    for nw, t, heads in ((32, 64, 2), (64, 16, 4)):
        c = heads * hd
        args = (_rnd(gen, dt, nw, t, c), 1 + _rnd(gen, F32, c, scale=0.1),
                _rnd(gen, F32, c, scale=0.1), _rnd(gen, dt, 3 * c, c, scale=c ** -0.5),
                _rnd(gen, dt, 3 * c, scale=0.02), _rnd(gen, dt, c, c, scale=c ** -0.5),
                _rnd(gen, dt, c, scale=0.02))
        before = (wa.window_attn_block.tiled, wa.window_attn_block.launches,
                  ga.attn_proj_residual.launches)
        _close(wa.window_attn_block(*args, heads=heads),
               wa.window_attn_block_plain(*args, heads=heads))
        assert (wa.window_attn_block.tiled, wa.window_attn_block.launches,
                ga.attn_proj_residual.launches) == (before[0] + 1, before[1], before[2] + 1)
    for nw, win, heads in ((32, 8, 4), (64, 4, 8)):
        ci, co = heads * hd // 2, heads * hd
        args = (_rnd(gen, dt, nw * win * win, ci), 1 + _rnd(gen, F32, ci, scale=0.1),
                _rnd(gen, F32, ci, scale=0.1), _rnd(gen, dt, co, ci, scale=ci ** -0.5),
                _rnd(gen, dt, co, scale=0.02), _rnd(gen, dt, 3 * co, ci, scale=ci ** -0.5),
                _rnd(gen, dt, 3 * co, scale=0.02), _rnd(gen, dt, co, co, scale=co ** -0.5),
                _rnd(gen, dt, co, scale=0.02))
        before = (wa.qpool_attn_block.tiled, wa.qpool_attn_block.launches)
        _close(wa.qpool_attn_block(*args, heads=heads, win=win),
               wa.qpool_attn_block_plain(*args, heads=heads, win=win))
        assert (wa.qpool_attn_block.tiled, wa.qpool_attn_block.launches) == \
            (before[0] + 1, before[1])
    heads = 8
    c = heads * hd
    x = _rnd(gen, dt, 1, 4096, c)
    ln = (1 + _rnd(gen, F32, c, scale=0.1), _rnd(gen, F32, c, scale=0.1))
    wqkv, bqkv = _rnd(gen, dt, 3 * c, c, scale=c ** -0.5), _rnd(gen, dt, 3 * c, scale=0.02)
    wproj, bproj = _rnd(gen, dt, c, c, scale=c ** -0.5), _rnd(gen, dt, c, scale=0.02)
    q, k, v = ga.ln_qkv(x, *ln, wqkv, bqkv, heads)
    _close(torch.stack((q, k, v)), ga.ln_qkv_plain(x, *ln, wqkv, bqkv, heads))
    o = fa.flash_attn(q, k, v)
    _close(o, fa.flash_attn_plain(q, k, v))
    _close(ga.attn_proj_residual(x, o, wproj, bproj),
           ga.attn_proj_residual_plain(x, o, wproj, bproj))


def _pad(t, width):
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def test_width_60_bf16_kernels_match_plain(gen):
    """Rows of true width 60 zero-padded to 64 (a bf16 Hiera block off a
    multiple of 8, hiera.pad_block): mlp_block and ln_qkv with the true
    width as the LayerNorm's divisor, each against its plain version on
    the same padded inputs, whose real columns are the unpadded plain
    functions' and whose padding stays zero."""
    dt, c, cp, t = torch.bfloat16, 60, 64, 1000
    x = _pad(_rnd(gen, dt, t, c), cp)
    ln = (_pad(1 + _rnd(gen, F32, c, scale=0.1), cp), _pad(_rnd(gen, F32, c, scale=0.1), cp))
    w0 = _pad(_rnd(gen, dt, 4 * c, c, scale=c ** -0.5), cp)
    b0 = _rnd(gen, dt, 4 * c, scale=0.02)
    w1 = _pad(_rnd(gen, dt, c, 4 * c, scale=(4 * c) ** -0.5).t(), cp).t().contiguous()
    b1 = _pad(_rnd(gen, dt, c, scale=0.02), cp)
    before = mb.mlp_block.launches
    got = mb.mlp_block(x, *ln, w0, b0, w1, b1, ln_width=c)
    assert mb.mlp_block.launches == before + 1
    _close(got, mb.mlp_block_plain(x, *ln, w0, b0, w1, b1, ln_width=c))
    _close(got[:, :c], mb.mlp_block_plain(x[:, :c], ln[0][:c], ln[1][:c], w0[:, :c], b0,
                                          w1[:c], b1[:c]))
    assert not got[:, c:].any()
    w = _pad(_rnd(gen, dt, 3 * 64, c, scale=c ** -0.5), cp)
    b = _rnd(gen, dt, 3 * 64, scale=0.02)
    xb = x.view(10, 100, cp)
    before = ga.ln_qkv.launches
    got = ga.ln_qkv(xb, *ln, w, b, 1, ln_width=c)
    assert ga.ln_qkv.launches == before + 1
    _close(got, ga.ln_qkv_plain(xb, *ln, w, b, 1, ln_width=c))
    _close(got, ga.ln_qkv_plain(xb[..., :c], ln[0][:c], ln[1][:c], w[:, :c], b, 1))


@pytest.mark.parametrize("dim,dim_out,q_stride", [(60, 60, False), (60, 120, True)])
def test_width_60_bf16_blocks_launch_bf16_kernels(gen, monkeypatch, dim, dim_out, q_stride):
    """A bf16 Hiera block of width 60 on the card (the window block of
    stage 1 and the 60 → 120 transition) launches the bf16 kernels on
    padded rows — the tiled route and mlp_block — and gives, within the
    bf16 rule, what the same block gives on the CPU with the padded route
    forced, where the plain versions stand in for the kernels."""
    from circuitvision_tpu_torch.models.layers import place
    from circuitvision_tpu_torch.models.sam2 import hiera

    torch.manual_seed(0)
    blk = hiera.MultiScaleBlock(dim, dim_out, dim_out // 60, q_stride=q_stride)
    with torch.no_grad():
        for p_ in blk.parameters():
            p_.normal_(0.0, 0.1)
    cpu = place(blk, "cpu", torch.bfloat16).eval()
    x = _rnd(gen, torch.bfloat16, 16, 8, 8, dim)
    partitioned = not q_stride
    card = place(__import__("copy").deepcopy(cpu), "cuda", torch.bfloat16)
    counters = (mb.mlp_block, ga.ln_qkv, fa.flash_attn, ga.attn_proj_residual,
                wa.window_attn_block, wa.qpool_attn_block)
    before = [f.launches for f in counters]
    with torch.no_grad():
        got = card(x, 8, partitioned)
        monkeypatch.setattr(hiera, "pad_block",
                            lambda t, d, do: t.dtype == torch.bfloat16 and bool(d % 8 or do % 8))
        ref = cpu(x.cpu(), 8, partitioned)
    launched = [f.launches - b for f, b in zip(counters, before)]
    assert launched == [1, 2 if q_stride else 1, 1, 1, 0, 0]
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    _close(got.cpu(), ref)


# ------------------------------------------- flash attention with a gradient
#: (B, H, Nq, Nk, D): SAM2.1-L's global blocks (1 × 8 heads × 4096, D 72)
#: and Hiera-t@1024's (1 × 4 × 4096, D 96), rows and keys off the 64-row
#: tiles, Nq ≠ Nk, narrower heads on the bf16 instances of widths 72 and
#: 96 (64, 8; 88), and float32 widths up to 128
BWD_SHAPES = [(1, 8, 4096, 4096, 72), (2, 2, 100, 70, 72), (1, 3, 17, 257, 64),
              (2, 2, 65, 64, 8), (1, 4, 4096, 4096, 96), (2, 2, 100, 70, 96),
              (1, 2, 300, 257, 88)]
BWD_SHAPES_F32 = BWD_SHAPES + [(2, 2, 100, 70, 128), (1, 2, 33, 65, 20)]


def _attn_case(gen, dt, b, h, nq, nk, d):
    q, k, v = _rnd(gen, dt, b, h, nq, d), _rnd(gen, dt, b, h, nk, d), _rnd(gen, dt, b, h, nk, d)
    return q, k, v, _rnd(gen, dt, b, h, nq, d)


@pytest.mark.parametrize("dt,shape", [(torch.bfloat16, s) for s in BWD_SHAPES]
                         + [(torch.float32, s) for s in BWD_SHAPES_F32])
def test_flash_attn_lse_kernel(gen, dt, shape):
    """K1: flash_attn's lse instance — o as the plain forward's, lse (float32)
    within 1e-4 · max(1, max |lse|) in either dtype (float32 scores)."""
    q, k, v, _ = _attn_case(gen, dt, *shape)
    before = fa.flash_attn_lse.launches
    o, lse = fa.flash_attn_lse(q, k, v)
    o_ref, lse_ref = fa.flash_attn_lse_plain(q, k, v)
    assert fa.flash_attn_lse.launches == before + 1
    _close(o, o_ref)
    _close(lse, lse_ref)


@pytest.mark.parametrize("dt,shape", [(torch.bfloat16, s) for s in BWD_SHAPES]
                         + [(torch.float32, s) for s in BWD_SHAPES_F32])
def test_flash_attn_bwd_kernels(gen, dt, shape):
    """K3 then K2 against flash_attn_bwd_plain on the same o and lse: dq,
    delta, dk and dv, each by the dtype it returns."""
    q, k, v, do = _attn_case(gen, dt, *shape)
    o, lse = fa.flash_attn_lse_plain(q, k, v)
    lse = lse.float()
    dq_ref, dk_ref, dv_ref = fa.flash_attn_bwd_plain(q, k, v, o, lse, do)
    before = (fa.flash_attn_bwd_dq.launches, fa.flash_attn_bwd_dkv.launches)
    dq, delta = fa.flash_attn_bwd_dq(q, k, v, o, lse, do)
    dk, dv = fa.flash_attn_bwd_dkv(q, k, v, lse, delta, do)
    assert (fa.flash_attn_bwd_dq.launches, fa.flash_attn_bwd_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    _close(delta, (do.float() * o.float()).sum(-1))
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        _close(got, ref)


def test_flash_bwd_smem_matches_kernels(gen):
    """The bf16 backward's instance width and shared memory as the Python
    side works them out against the kernels' own (csrc/flash_bwd.cu
    cv_flash_bwd_bf16_smem) at every head width a multiple of 8 up to 96,
    and no instance past them."""
    lib = build.library("flash_bwd")
    for hd in range(8, 97, 8):
        assert lib.cv_flash_bwd_bf16_smem(hd) == fa.flash_bwd_tc_smem(fa.grad_width(hd)), hd
    for hd in (4, 60, 104, 128):
        assert lib.cv_flash_bwd_bf16_smem(hd) == 0, hd


@pytest.mark.parametrize("dt", DTYPES)
def test_flash_attention_gradients_on_card(gen, dt):
    """FlashAttention under autograd on the card: one launch of each of
    K1, K3 and K2, and the gradients of its kernels against its plain
    backward (the card's own o and lse fed to both), at a global-block
    shape with a true head width below the instance's."""
    q, k, v, do = _attn_case(gen, dt, 2, 8, 1024, 1024, 72)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = (fa.flash_attn_lse.launches, fa.flash_attn_bwd_dq.launches,
              fa.flash_attn_bwd_dkv.launches)
    o = fa.flash_attention(q, k, v, 64)
    grads = torch.autograd.grad(o, (q, k, v), do)
    assert (fa.flash_attn_lse.launches, fa.flash_attn_bwd_dq.launches,
            fa.flash_attn_bwd_dkv.launches) == tuple(n + 1 for n in before)
    with torch.no_grad():
        o2, lse = fa.flash_attn_lse(q, k, v, 64)
        ref = fa.flash_attn_bwd_plain(q, k, v, o2, lse, do, 64)
    assert torch.equal(o, o2)
    for got, r in zip(grads, ref):
        _close(got, r)


def test_kernel_wrappers_refuse_operands_that_require_grad(gen):
    """Each wrapper of a kernel without a backward raises under grad mode
    when an operand requires grad, instead of cutting the gradient; under
    torch.no_grad() the same call runs."""
    dt = torch.float32
    x = _rnd(gen, dt, 64, 32)
    s, bias = 1 + _rnd(gen, F32, 32, scale=0.1), _rnd(gen, F32, 32, scale=0.1)
    w0, b0, w1, b1 = (_rnd(gen, dt, 128, 32, scale=0.2), _rnd(gen, dt, 128),
                      _rnd(gen, dt, 32, 128, scale=0.1), _rnd(gen, dt, 32))
    wq, bq, wp, bp = (_rnd(gen, dt, 96, 32, scale=0.2), _rnd(gen, dt, 96),
                      _rnd(gen, dt, 32, 32, scale=0.2), _rnd(gen, dt, 32))
    ws, bs = _rnd(gen, dt, 64, 32, scale=0.2), _rnd(gen, dt, 64)
    wq2, bq2, wp2, bp2 = (_rnd(gen, dt, 192, 32, scale=0.2), _rnd(gen, dt, 192),
                          _rnd(gen, dt, 64, 64, scale=0.2), _rnd(gen, dt, 64))
    q = _rnd(gen, dt, 1, 2, 64, 16)
    logits = _rnd(gen, dt, 1, 32, 32, 1)
    refine = ([_rnd(gen, dt, 4, 1, kk, kk) for kk in rf.KERNELS],
              [_rnd(gen, dt, 4) for _ in rf.KERNELS], _rnd(gen, dt, 1, 16, 1, 1), _rnd(gen, dt, 1))
    calls = {
        "mlp_block": (lambda: mb.mlp_block(x, s, bias, w0, b0, w1, b1), w0),
        "window_attn_block": (lambda: wa.window_attn_block(
            x.view(4, 16, 32), s, bias, wq, bq, wp, bp, heads=2), x),
        "qpool_attn_block": (lambda: wa.qpool_attn_block(
            x, s, bias, ws, bs, wq2, bq2, wp2, bp2, heads=2, win=4), bs),
        "ln_qkv": (lambda: ga.ln_qkv(x.view(1, 64, 32), s, bias, wq, bq, 2), s),
        "attn_proj_residual": (lambda: ga.attn_proj_residual(
            x.view(1, 64, 32), q, wp, bp), wp),
        "flash_attn": (lambda: fa.flash_attn(q, q, q), q),
        "flash_attn_lse": (lambda: fa.flash_attn_lse(q, q, q), q),
        "refinement": (lambda: rf.refinement(logits, *refine), refine[2]),
        "enhance_lines_fused": (lambda: mo.enhance_lines_fused(
            (_rnd(gen, dt, 40, 50).abs() * 50)), None),
        "fused_layernorm": (lambda: fl.fused_layernorm(x, s, bias), bias),
        "fused_add_layernorm": (lambda: fl.fused_add_layernorm(x, x, s, bias), x),
    }
    for name, (call, operand) in calls.items():
        with torch.no_grad():
            call()
        if operand is None:  # the mask is the one operand: make it require grad
            m = (_rnd(gen, dt, 40, 50).abs() * 50).requires_grad_()
            with pytest.raises(build.KernelError, match="requires grad"):
                mo.enhance_lines_fused(m)
            continue
        operand.requires_grad_()
        try:
            with pytest.raises(build.KernelError, match="requires grad"):
                call()
        finally:
            operand.requires_grad_(False)


def test_training_refuses_bf16_heads_flash_cannot_take(gen):
    """A Hiera layout at 1024 whose global heads are 104 wide in bfloat16 —
    past FlashAttention's widest bf16 instance, 96 — is refused with its
    width named when the whole-tree step is made and before a LoRA step
    runs; in float32 the same model is taken, and so is bfloat16
    Hiera-t@1024 (global heads of 96)."""
    from circuitvision_tpu_torch.core.config import SAM2Config, TrainConfig
    from circuitvision_tpu_torch.models.sam2.wrapper import SAM2ImageSegmenter
    from circuitvision_tpu_torch.train import lora, train_step

    t = dict(resolution=1024, num_heads=1, stages=(1, 2, 7, 2), global_att_blocks=(5, 7, 9),
             window_spec=(8, 4, 14, 7))
    model = SAM2ImageSegmenter(SAM2Config(embed_dim=104, **t)).to("cuda", torch.bfloat16)
    opt, mask = train_step.make_optimizer(model, TrainConfig(), None)
    all_true = {n: True for n in mask}
    with pytest.raises(build.KernelError, match="width 104"):
        train_step.make_train_step(model, opt, mask=all_true, selective=False)
    train_step.make_train_step(model, opt, mask=mask)  # the surface: no trunk block trains
    tstate = lora.init_train_state(model, torch.Generator().manual_seed(0), n_trunk_blocks=12)
    step = lora.make_lora_train_step(model, lora.make_lora_optimizer())
    with pytest.raises(build.KernelError, match="width 104"):
        step(dict(model.named_parameters()), tstate, None, None, None)
    train_step.make_train_step(model.float(), opt, mask=all_true, selective=False)
    tiny = SAM2ImageSegmenter(SAM2Config(embed_dim=96, **t)).to("cuda", torch.bfloat16)
    train_step.make_train_step(tiny, train_step.make_optimizer(tiny, TrainConfig(), None)[0],
                               mask={n: True for n, _ in tiny.named_parameters()},
                               selective=False)
