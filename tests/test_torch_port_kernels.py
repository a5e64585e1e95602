"""The plain PyTorch versions of the port's four kernels against the JAX
package's Pallas kernels (interpret mode, called as
tests/test_pallas_kernels.py calls them) and against the JAX module
math, on the same numpy inputs; and the wrappers' dispatch on the CPU.

Tolerances are float32: 1e-4 absolute for the MLP and refinement halves
(sums of up to a few hundred products in another order), 1e-5 of the
output's scale for the attention halves, as the Pallas tests use.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitvision_tpu.models.sam2 import hiera as jhiera
from circuitvision_tpu.ops.pallas.mlp_block import mlp_block as pallas_mlp
from circuitvision_tpu.ops.pallas.refinement_fused import refinement_fused as pallas_refine
from circuitvision_tpu.ops.pallas.window_attn import (
    qpool_attn_block as pallas_qpool,
    window_attn_block as pallas_window,
)
from circuitvision_tpu_torch.ops.cuda import build
from circuitvision_tpu_torch.ops.cuda import flash_attn as tflash
from circuitvision_tpu_torch.ops.cuda import global_attn as tglobal
from circuitvision_tpu_torch.ops.cuda import mlp_block as tmlp
from circuitvision_tpu_torch.ops.cuda import refinement as trefine
from circuitvision_tpu_torch.ops.cuda import window_attn as twin

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _ln(x, s, b):
    mean = x.mean(-1, keepdims=True)
    var = np.maximum((x * x).mean(-1, keepdims=True) - mean * mean, 0.0)
    return (x - mean) / np.sqrt(var + 1e-6) * s + b


# ---------------------------------------------------------------- mlp_block
@pytest.mark.parametrize("t,c", [(100, 48), (64, 96)])
def test_mlp_block_plain_matches_pallas(t, c):
    rng = np.random.default_rng(0)
    h = 4 * c
    x, lns, lnb = _arr(rng, t, c), _arr(rng, c), _arr(rng, c)
    w0, b0 = _arr(rng, c, h, scale=0.1), _arr(rng, h, scale=0.05)
    w1, b1 = _arr(rng, h, c, scale=0.1), _arr(rng, c, scale=0.05)
    ref = np.asarray(pallas_mlp(*map(jnp.asarray, (x, lns, lnb, w0, b0, w1, b1)),
                                row_tile=32, hidden_chunk=h // 2, interpret=True))
    # torch Linear layout: (out, in)
    got = tmlp.mlp_block_plain(*_t(x, lns, lnb, w0.T.copy(), b0, w1.T.copy(), b1)).numpy()
    assert np.abs(got - ref).max() < 1e-4
    # and the module math (LN2 → Dense → exact GELU → Dense → residual)
    mod = x + np.asarray(jax.nn.gelu(jnp.asarray(_ln(x, lns, lnb) @ w0 + b0),
                                     approximate=False)) @ w1 + b1
    assert np.abs(got - mod).max() < 1e-4


def test_mlp_block_wrapper_takes_plain_on_cpu():
    rng = np.random.default_rng(1)
    args = _t(_arr(rng, 8, 16), _arr(rng, 16), _arr(rng, 16), _arr(rng, 64, 16),
              _arr(rng, 64), _arr(rng, 16, 64), _arr(rng, 16))
    before = tmlp.mlp_block.launches
    torch.testing.assert_close(tmlp.mlp_block(*args), tmlp.mlp_block_plain(*args),
                               rtol=0, atol=0)
    assert tmlp.mlp_block.launches == before  # no kernel launched on the CPU


# ---------------------------------------------------------- window attention
def _window_args(rng, c):
    return (_arr(rng, c), _arr(rng, c), _arr(rng, c, 3 * c, scale=0.1),
            _arr(rng, 3 * c, scale=0.05), _arr(rng, c, c, scale=0.1), _arr(rng, c, scale=0.05))


@pytest.mark.parametrize("wt,t,c,heads", [(8, 16, 48, 2), (4, 64, 32, 1), (6, 4, 32, 4)])
def test_window_attn_plain_matches_pallas(wt, t, c, heads):
    rng = np.random.default_rng(2)
    x = _arr(rng, wt, t, c)
    lns, lnb, wqkv, bqkv, wproj, bproj = _window_args(rng, c)
    ref = np.asarray(pallas_window(*map(jnp.asarray, (x, lns, lnb, wqkv, bqkv, wproj, bproj)),
                                   heads=heads, gw=wt // 2, interpret=True))
    got = twin.window_attn_block_plain(
        *_t(x, lns, lnb, wqkv.T.copy(), bqkv, wproj.T.copy(), bproj), heads=heads).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


def test_window_attn_plain_matches_module_block():
    """A partitioned Hiera block's attention half on the JAX module path
    (CPU: LN1 → MultiScaleAttention → residual), through the kernel's
    plain version."""
    rng = np.random.default_rng(3)
    c, heads = 32, 2
    x = _arr(rng, 4, 4, 4, c)  # 4 windows of 4×4
    blk = jhiera.MultiScaleBlock(dim=c, dim_out=c, num_heads=heads)
    v = jax.tree.map(np.asarray, blk.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    p = v["params"]
    # attention half only: zero the MLP so out = x + attn(x) + 0
    p["mlp_layers_1"]["kernel"] = np.zeros_like(p["mlp_layers_1"]["kernel"])
    ref = np.asarray(blk.apply({"params": p}, jnp.asarray(x)))
    got = twin.window_attn_block_plain(
        *_t(x.reshape(4, 16, c), p["norm1"]["scale"], p["norm1"]["bias"],
            p["attn"]["qkv"]["kernel"].T.copy(), p["attn"]["qkv"]["bias"],
            p["attn"]["proj"]["kernel"].T.copy(), p["attn"]["proj"]["bias"]),
        heads=heads).numpy().reshape(x.shape)
    assert np.abs(got - ref).max() < 1e-5


@pytest.mark.parametrize("win,s,heads", [(4, 8, 2), (8, 16, 2), (2, 8, 4)])
def test_qpool_attn_plain_matches_pallas_and_module(win, s, heads):
    rng = np.random.default_rng(4)
    b, ci, co = 2, 32, 64
    x = _arr(rng, b, s, s, ci)
    lns, lnb = _arr(rng, ci), _arr(rng, ci)
    wsk, bsk = _arr(rng, ci, co, scale=0.1), _arr(rng, co, scale=0.05)
    wqkv, bqkv = _arr(rng, ci, 3 * co, scale=0.1), _arr(rng, 3 * co, scale=0.05)
    wpr, bpr = _arr(rng, co, co, scale=0.1), _arr(rng, co, scale=0.05)
    xw, _ = jhiera.window_partition(jnp.asarray(x), win)
    nw = xw.shape[0]
    rows = np.asarray(xw).reshape(nw * win * win, ci)
    got = twin.qpool_attn_block_plain(
        *_t(rows, lns, lnb, wsk.T.copy(), bsk, wqkv.T.copy(), bqkv, wpr.T.copy(), bpr),
        heads=heads, win=win).numpy()
    scale = 1.0
    if (win * win) % 8 == 0:  # the Pallas kernel tiles rows in eights
        ref = np.asarray(pallas_qpool(*map(jnp.asarray, (rows, lns, lnb, wsk, bsk, wqkv, bqkv,
                                                         wpr, bpr)),
                                      heads=heads, win=win, interpret=True))
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() / scale < 1e-5
    # module path: a q_stride MultiScaleBlock with the MLP zeroed
    blk = jhiera.MultiScaleBlock(dim=ci, dim_out=co, num_heads=heads, q_stride=True,
                                 window_size=win)
    params = {
        "norm1": {"scale": lns, "bias": lnb}, "proj": {"kernel": wsk, "bias": bsk},
        "attn": {"qkv": {"kernel": wqkv, "bias": bqkv}, "proj": {"kernel": wpr, "bias": bpr}},
        "norm2": {"scale": np.ones(co, np.float32), "bias": np.zeros(co, np.float32)},
        "mlp_layers_0": {"kernel": np.zeros((co, 4 * co), np.float32),
                         "bias": np.zeros(4 * co, np.float32)},
        "mlp_layers_1": {"kernel": np.zeros((4 * co, co), np.float32),
                         "bias": np.zeros(co, np.float32)},
    }
    mod = np.asarray(blk.apply({"params": params}, jnp.asarray(x)))
    m = win // 2
    out = got.reshape(nw, m, m, co)
    full = np.asarray(jhiera.window_unpartition(jnp.asarray(out), m, (s // 2, s // 2),
                                                (s // 2, s // 2)))
    assert np.abs(full - mod).max() / max(scale, np.abs(mod).max()) < 1e-5


# --------------------------------------------------------------- refinement
def _refine_params(rng):
    ws = [_arr(rng, k, k, 1, 4, scale=0.2) for k in trefine.KERNELS]
    bs = [_arr(rng, 4, scale=0.1) for _ in trefine.KERNELS]
    return ws, bs, _arr(rng, 1, 1, 16, 1, scale=0.3), _arr(rng, 1)


@pytest.mark.parametrize("shape", [(2, 96, 160, 1), (1, 70, 130, 1)])
def test_refinement_plain_matches_pallas(shape):
    rng = np.random.default_rng(5)
    x = _arr(rng, *shape)
    ws, bs, wc, bc = _refine_params(rng)
    ref = np.asarray(pallas_refine(jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                                   tuple(map(jnp.asarray, bs)), jnp.asarray(wc),
                                   jnp.asarray(bc), tile_h=32, interpret=True))
    got = trefine.refinement_plain(
        torch.from_numpy(x), [torch.from_numpy(w.transpose(3, 2, 0, 1).copy()) for w in ws],
        _t(*bs), torch.from_numpy(wc.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bc),
    ).numpy()
    assert np.abs(got - ref).max() < 1e-4


def test_refinement_wrapper_takes_plain_on_cpu():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(_arr(rng, 1, 24, 40, 1))
    ws, bs, wc, bc = _refine_params(rng)
    wst = [torch.from_numpy(w.transpose(3, 2, 0, 1).copy()) for w in ws]
    before = trefine.refinement.launches
    args = (x, wst, _t(*bs), torch.from_numpy(wc.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(bc))
    torch.testing.assert_close(trefine.refinement(*args), trefine.refinement_plain(*args),
                               rtol=0, atol=0)
    assert trefine.refinement.launches == before


# -------------------------------------------------------------- build side
def test_build_raises_kernel_error_without_nvcc(monkeypatch, tmp_path):
    """Where no nvcc exists, building raises KernelError (no silent
    fallback); a missing compiler is simulated by an empty PATH."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD", tmp_path / "build")
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has /usr/local/cuda/bin/nvcc")
    with pytest.raises(build.KernelError):
        build.build_all()


def test_launcher_signatures_match_sources():
    """Every launcher the ctypes table declares is exported by its
    source with the same number of parameters, and every function a
    source exports is in the table."""
    for name, fns in build.SIGNATURES.items():
        src = (build.CSRC / f"{name}.cu").read_text()
        for fn, argtypes in fns.items():
            m = re.search(r'extern "C" [\w ]+ ' + fn + r"\(([^)]*)\)", src)
            assert m, f"{fn} not exported by {name}.cu"
            assert len(m.group(1).split(",")) == len(argtypes), fn
        assert set(re.findall(r'extern "C" [\w ]+ (cv_\w+)\(', src)) == set(fns), name


def test_wrappers_reject_unsupported_operands():
    """Non-CPU tensors must be CUDA tensors of one float dtype: a meta
    tensor is refused before any build or launch."""
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(build.KernelError):
        tmlp.mlp_block(x, *(torch.empty(8, device="meta") for _ in range(2)),
                       torch.empty(32, 8, device="meta"), torch.empty(32, device="meta"),
                       torch.empty(8, 32, device="meta"), torch.empty(8, device="meta"))
    with pytest.raises(build.KernelError):
        build.dtype_code(torch.empty(2, dtype=torch.float16))


# ------------------------------------------------------------ launch plans
#: (T, C) of every mlp_block call of Hiera-t@512 and Hiera-L@1024 at one
#: image (stages at 128², 64², 32², 16² and 256², 128², 64², 32² tokens)
MLP_SHAPES = [(16384, 96), (4096, 192), (1024, 384), (256, 768),
              (65536, 144), (16384, 288), (4096, 576), (1024, 1152)]
#: (batch·heads, Nq, Nk, head width) of every flash_attn shape of the two
#: configs: global blocks; windows through the tiled route (windows ×
#: heads, window tokens); q-pool transitions (Nq = Nk / 4)
FLASH_SHAPES = [
    # t@512: global 32² tokens, 4 heads; windows 8², 4², 14² (on a 42²
    # padded map), 7² (21²); q-pools 8 → 4, 4 → 2, 14 → 7
    (4, 1024, 1024, 96), (256, 64, 64, 96), (512, 16, 16, 96), (36, 196, 196, 96),
    (72, 49, 49, 96), (512, 16, 64, 96), (1024, 4, 16, 96), (72, 49, 196, 96),
    # L@1024: global 64² tokens, 8 heads; windows 8², 4², 16², 8²;
    # q-pools 8 → 4, 4 → 2, 16 → 8
    (8, 4096, 4096, 72), (2048, 64, 64, 72), (4096, 16, 16, 72), (128, 256, 256, 72),
    (256, 64, 64, 72), (4096, 16, 64, 72), (8192, 4, 16, 72), (256, 64, 256, 72),
]
SMS = 132


@pytest.mark.parametrize("t,c", MLP_SHAPES)
def test_mlp_plan_fits_and_covers(t, c):
    """The bf16 mlp_block plan: shared memory within a block's 227 KB, the
    hidden dimension covered exactly by GEMM 1's columns and GEMM 2's
    depth, tiles that wgmma m64n128k16 and the 128-byte swizzle can take,
    and at least one block per SM wherever 64-row blocks give that many."""
    hidden = 4 * c
    plan = tmlp.mlp_plan(t, c, hidden, SMS)
    assert c % 16 == 0 and hidden % 64 == 0
    assert plan.ln_smem <= build.MAX_SMEM and plan.ln_blocks * tmlp.LN_ROWS >= t
    assert plan.workspace == t * (c + hidden)
    # wgmma: 64 rows a warpgroup, n a multiple of 8 up to 256, k steps of
    # 16; a staged row is one 128-byte swizzle span; rows copied in
    # 16-byte pieces
    assert tmlp.GEMM_BN % 8 == 0 and tmlp.GEMM_BN <= 256
    assert tmlp.GEMM_BK % 16 == 0 and tmlp.GEMM_BK * 2 == 128
    for g, n, k in ((plan.gemm1, hidden, c), (plan.gemm2, c, hidden)):
        assert g.bm in tmlp.GEMM_ROWS and g.bm % 64 == 0 and k % 8 == 0 and n % 2 == 0
        assert g.smem == tmlp.gemm_smem(g.bm) <= build.MAX_SMEM
        assert (g.bm + tmlp.GEMM_BN) * 128 % 1024 == 0  # every stage on the swizzle's alignment
        cols = -(-n // tmlp.GEMM_BN)
        assert (cols - 1) * tmlp.GEMM_BN < n <= cols * tmlp.GEMM_BN
        assert g.blocks == -(-t // g.bm) * cols
        if -(-t // 64) * cols >= SMS:
            assert g.blocks >= SMS
    steps = -(-hidden // tmlp.GEMM_BK)
    assert (steps - 1) * tmlp.GEMM_BK < hidden <= steps * tmlp.GEMM_BK


@pytest.mark.parametrize("bh,nq,nk,hd", FLASH_SHAPES)
def test_flash_plan_fits_and_covers(bh, nq, nk, hd):
    """The bf16 flash_attn plan: shared memory within 227 KB, the padded
    depth a multiple of mma's k = 16 and the head's columns whole 8-wide
    n tiles, conflict-free ldmatrix rows, every q row in a tile, and at
    least one block per SM wherever the 16-row q tiles fill 132 blocks."""
    plan = tflash.flash_plan(bh, nq, nk, hd, SMS)
    assert plan.smem == tflash.flash_tc_smem(plan.width, plan.mt, plan.wpp, plan.stages)
    assert plan.smem <= build.MAX_SMEM
    assert hd <= plan.width in tflash.TC_WIDTHS and plan.width % 8 == 0
    depth = tflash.tc_depth(plan.width)
    assert depth % 16 == 0 and plan.width <= depth < plan.width + 16
    ld_words = (depth + 8) // 2
    assert ld_words % 8 == 4
    assert plan.wpp in (1, 2, 4) and (plan.stages == 2 or nk <= tflash.TC_KEYS)
    assert plan.mt == 1 or (plan.wpp == tflash.TC_WARPS and plan.width <= tflash.TC_MAX_WIDE_WIDTH)
    rows = tflash.TC_Q_ROWS * plan.mt * plan.wpp
    tiles = bh * -(-nq // rows)
    assert plan.blocks * (tflash.TC_WARPS // plan.wpp) >= tiles
    assert plan.blocks == -(-tiles // (tflash.TC_WARPS // plan.wpp))
    if nq <= tflash.TC_Q_ROWS:
        assert plan.wpp == 1  # one problem per warp, four a block
    if bh * -(-nq // tflash.TC_Q_ROWS) >= tflash.TC_WARPS * SMS:
        assert plan.blocks >= SMS


@pytest.mark.parametrize("hd", [4, 36, 264])
def test_flash_plan_refuses_head_widths(hd):
    """bf16 rows are copied in 16-byte pieces: head widths that are not a
    multiple of 8 (the tiled route pads them first), or wider than the
    widest instance (256), are refused."""
    with pytest.raises(build.KernelError):
        tflash.flash_plan(8, 64, 64, hd)


@pytest.mark.parametrize("hd", [8, 56, 64, 72, 80, 88, 96])
def test_flash_bwd_width_and_smem(hd):
    """The bf16 backward kernels at a head of width hd (csrc/flash_bwd.cu;
    the card tests compare the C side's sizes): the narrowest instance
    that holds the head (SAM2.1-b+'s 56 and L's 72 on 72, t's and s's 96
    on 96), its depth padded to mma's k = 16 with the head's columns whole
    8-wide n tiles, conflict-free ldmatrix rows, and six 64-row tiles and
    1 KB of row values within 227 KB, two blocks to an SM."""
    width = tflash.grad_width(hd)
    assert width == min(w for w in tflash.LSE_WIDTHS if w >= hd) and width % 8 == 0
    depth = tflash.tc_depth(width)
    assert depth % 16 == 0 and width <= depth < width + 16
    assert ((depth + 8) // 2) % 8 == 4
    smem = tflash.flash_bwd_tc_smem(width)
    assert smem == 6 * tflash.BWD_TILE * (depth + 8) * 2 + 2 * 2 * tflash.BWD_TILE * 4
    assert 2 * (smem + 1024) <= 228 * 1024 and smem <= build.MAX_SMEM


@pytest.mark.parametrize("hd", [4, 60, 100, 104, 128])
def test_flash_bwd_refuses_head_widths(hd):
    """bf16 rows are copied in 16-byte pieces and the widest instance is
    128: the kernels' instances (grad_width) refuse a width off a
    multiple of 8 and one past 128, as the C side refuses them; such a
    head below 128 reaches them zero-padded to the next multiple of 8
    (FlashAttention's padded route, grad_pad_width), so FlashAttention
    takes every one of these widths."""
    padded = tflash.grad_pad_width(hd, torch.bfloat16, torch.device("cuda"))
    assert padded == -(-hd // 8) * 8
    if hd % 8:
        with pytest.raises(build.KernelError):
            tflash.grad_width(hd)
    assert tflash.grad_width(padded) == next(w for w in tflash.LSE_WIDTHS if w >= padded)
    with pytest.raises(build.KernelError):
        tflash.grad_width(padded + 128)
    assert tflash.grad_head_width_ok(hd, torch.bfloat16)
    assert not tflash.grad_head_width_ok(hd + 128, torch.bfloat16)


def test_flash_grad_instances_match_the_sources():
    """The widths and tile the Python side plans with are the C side's:
    flash_bwd.cu's bf16 instances (kBwdWidths) and tile (kB), the bf16
    lse forward's instances in flash_attn.cu, and the instances' smem
    formula (bwd_tc_smem: six tiles and 4·kB floats)."""
    bwd = (build.CSRC / "flash_bwd.cu").read_text()
    widths = re.search(r"constexpr int kBwdWidths\[3\] = \{(\d+), (\d+), (\d+)\};", bwd)
    assert tuple(int(w) for w in widths.groups()) == tflash.LSE_WIDTHS
    assert re.search(r"constexpr int kB = (\d+);", bwd).group(1) == str(tflash.BWD_TILE)
    assert "sizeof(bf16) * 6 * kB * ld + sizeof(float) * 4 * kB" in bwd
    fwd = (build.CSRC / "flash_attn.cu").read_text()
    lse = fwd[fwd.index('extern "C" int cv_flash_attn_lse_bf16'):]
    lse = lse[:lse.index("\n}\n")]
    assert tuple(sorted({int(w) for w in re.findall(r"width == (\d+)", lse)})) == \
        tflash.LSE_WIDTHS
    assert set(tflash.LSE_WIDTHS) <= set(tflash.TC_WIDTHS)


def test_mlp_plan_refuses_widths_off_16_bytes():
    with pytest.raises(build.KernelError):
        tmlp.mlp_plan(64, 100, 400)


def test_gemm_tile_rows():
    """128-row blocks where they give two per SM, else 64: T = 4096 takes
    128 rows for the 2304-wide product and 64 for the 576-wide one; T =
    1024 at C = 1152 reaches 144 blocks with 64."""
    assert tmlp.gemm_tile(4096, 2304).bm == 128
    assert tmlp.gemm_tile(4096, 576) == tmlp.GemmPlan(64, 320, tmlp.gemm_smem(64))
    assert tmlp.gemm_tile(1024, 1152).blocks == 144 >= SMS


#: (M, K, N) of every ln_qkv call of one Hiera-L@1024 analyze(): M = B·N
#: rows, K = C_in, N = slabs·heads·hd — the global blocks, the stage-3
#: and stage-4 windows on the tiled route, and both tiled q-pool
#: transitions (q/k/v, then the one-slab shortcut)
LN_QKV_SHAPES = [(4096, 576, 1728), (4096, 576, 1728), (1024, 1152, 3456), (65536, 144, 864),
                 (65536, 144, 288), (4096, 576, 3456), (4096, 576, 1152)]


@pytest.mark.parametrize("m,k,n", LN_QKV_SHAPES)
def test_ln_qkv_plan_fits_and_covers(m, k, n):
    """The bf16 ln_qkv plan: the LN pre-pass of mlp_block's bf16 path in
    shared memory and over every row, a workspace of m·k, and the shared
    GEMM's blocks covering the (m × n) output exactly, in tiles that
    wgmma m64n128k16 and the 128-byte swizzle take, with at least one
    block per SM wherever 64-row blocks give that many."""
    plan = tglobal.ln_qkv_plan(m, k, n, SMS)
    assert plan.ln_smem == tmlp.ln_smem(k) <= build.MAX_SMEM
    assert plan.ln_blocks * tmlp.LN_ROWS >= m > (plan.ln_blocks - 1) * tmlp.LN_ROWS
    assert plan.workspace == m * k
    g = plan.gemm
    assert k % 8 == 0 and n % 2 == 0
    assert g.bm in tmlp.GEMM_ROWS and g.smem == tmlp.gemm_smem(g.bm) <= build.MAX_SMEM
    assert (g.bm + tmlp.GEMM_BN) * 128 % 1024 == 0
    cols = -(-n // tmlp.GEMM_BN)
    assert (cols - 1) * tmlp.GEMM_BN < n <= cols * tmlp.GEMM_BN
    assert g.blocks == -(-m // g.bm) * cols and (-(-m // g.bm) - 1) * g.bm < m
    if -(-m // 64) * cols >= SMS:
        assert g.blocks >= SMS
    steps = -(-k // tmlp.GEMM_BK)
    assert (steps - 1) * tmlp.GEMM_BK < k <= steps * tmlp.GEMM_BK


#: (M, C) of every attn_proj_residual call of one Hiera-L@1024 analyze()
#: on the bf16 path, M = B·N rows, depth and output width C: the global
#: blocks, the stage-3 and stage-4 windows on the tiled route, and the
#: tiled q-pool transitions (16384 rows at 288 if the 144 → 288
#: transition takes the tiled route, as in float32; 1024 at 1152)
PROJ_RES_SHAPES = [(4096, 576), (4096, 576), (1024, 1152), (16384, 288), (1024, 1152)]


@pytest.mark.parametrize("m,c", PROJ_RES_SHAPES)
def test_proj_res_plan_fits_and_covers(m, c):
    """The bf16 attn_proj_residual plan: the shared GEMM's blocks cover
    the (m × c) output exactly, in tiles that wgmma m64n128k16 and the
    128-byte swizzle take, within a block's shared memory, with at least
    one block per SM wherever 64-row blocks give that many (the global
    block's 4096 × 576 takes 64 rows: 128 would give 160 blocks)."""
    g = tglobal.proj_res_plan(m, c, SMS)
    assert c % 8 == 0
    assert g.bm in tmlp.GEMM_ROWS and g.smem == tmlp.gemm_smem(g.bm) <= build.MAX_SMEM
    assert (g.bm + tmlp.GEMM_BN) * 128 % 1024 == 0
    cols = -(-c // tmlp.GEMM_BN)
    assert (cols - 1) * tmlp.GEMM_BN < c <= cols * tmlp.GEMM_BN
    assert g.blocks == -(-m // g.bm) * cols and (-(-m // g.bm) - 1) * g.bm < m
    if -(-m // 64) * cols >= SMS:
        assert g.blocks >= SMS
    steps = -(-c // tmlp.GEMM_BK)
    assert (steps - 1) * tmlp.GEMM_BK < c <= steps * tmlp.GEMM_BK
    if (m, c) == (4096, 576):
        assert g.bm == 64 and g.blocks == 320


def test_proj_res_plan_refuses_widths_off_16_bytes():
    with pytest.raises(build.KernelError):
        tglobal.proj_res_plan(64, 300)


def test_qpool_route_rule_bf16():
    """The bf16 q-pool kernel takes win 4 and 8 (16 and 64 tokens), the
    input widths it is built for (C_in 96, 144, 192, 288) and up to C_out
    = 576 — eight warps of eighteen 8-column units over two row tiles —
    and only where its shared memory fits: other shapes take the tiled
    route, never the f32 kernel, even where their bf16 size would fit."""
    bf = torch.bfloat16
    assert twin.window_route("qpool", 16, 288, 576, 8, bf) == "block"
    assert twin.window_route("qpool", 64, 144, 288, 4, bf) == "block"
    # C_out 720 at head width 72 (ten heads): the block kernel's heads
    # and shared memory fit, its eight warps do not
    assert twin.block_heads("qpool", 720, 10)
    assert twin.window_smem("qpool", 16, 96, 720, bf) <= build.MAX_SMEM
    assert twin.window_route("qpool", 16, 96, 720, 10, bf) == "tiled"
    assert twin.window_route("qpool", 36, 96, 192, 2, bf) == "tiled"
    # win 6 in float32 too: the 3×TF32 block pools whole m16 tiles (win 4, 8)
    assert twin.window_route("qpool", 36, 96, 192, 2) == "tiled"
    assert twin.window_route("qpool", 16, 576, 1152, 16, bf) == "tiled"
    assert twin.window_smem("qpool", 16, 112, 224, bf) <= build.MAX_SMEM
    assert twin.window_route("qpool", 16, 112, 224, 4, bf) == "tiled"


@pytest.mark.parametrize("k,n", [(100, 300), (144, 301)])
def test_ln_qkv_plan_refuses_widths_off_16_bytes(k, n):
    """Rows of the input are copied in 16-byte pieces (C_in a multiple of
    8) and the epilogue stores column pairs (an even output width)."""
    with pytest.raises(build.KernelError):
        tglobal.ln_qkv_plan(64, k, n)


#: (head width, heads) off the block kernels' 56/72/96 — multiples of 8,
#: which the tiled route takes, and 60, which no bf16 kernel takes — and
#: one at a preset width (96, Hiera-t/-s) that keeps its block kernel
HEAD_WIDTHS = [(32, 12), (64, 6), (80, 6), (128, 4), (60, 8), (96, 4)]


@pytest.mark.parametrize("hd,heads", HEAD_WIDTHS)
def test_block_route_by_head_width(hd, heads):
    """In bfloat16 a window (two heads, 16 tokens) or q-pool transition
    (win 4 and 8) whose head width has no block-kernel instance takes the
    tiled route, though its shape alone fits the block kernel; in float32
    the head width routes a window as in bfloat16 and a q-pool transition
    as in bfloat16 but for the pairing of heads (the 3×TF32 attention
    kernels' instances)."""
    bf, f32 = torch.bfloat16, torch.float32
    c, c_out = 2 * hd, hd * heads
    block = hd in twin.TC_HEAD_WIDTHS
    assert twin.window_route("window", 16, c, c, 2, bf) == ("block" if block else "tiled")
    assert twin.block_heads("window", c, 2) == block
    assert twin.window_route("window", 16, c, c, 2, f32) == ("block" if block else "tiled")
    for tokens, c_in in ((16, 192), (64, 96)):
        assert twin.window_route("qpool", tokens, c_in, c_out, heads, bf) == \
            ("block" if block else "tiled")
        assert twin.window_smem("qpool", tokens, c_in, c_out, f32) <= build.MAX_SMEM
        assert twin.window_route("qpool", tokens, c_in, c_out, heads, f32) == \
            ("block" if block else "tiled")
    # an odd number of heads at a preset width: the q-pool kernel takes two at a time
    assert twin.window_route("qpool", 16, 192, 3 * 96, 3, bf) == "tiled"
    assert twin.window_route("qpool", 16, 192, 3 * 96, 3, f32) == "block"


@pytest.mark.parametrize("hd,heads", HEAD_WIDTHS)
def test_tiled_and_global_instances_by_head_width(hd, heads):
    """The kernels of the tiled route and the global blocks at each head
    width, bf16: flash_attn pads it to the next of TC_WIDTHS,
    attn_proj_residual takes its template instance at 56/72/96 and the
    runtime-width A layout at every other multiple of 8 (its plan is the
    width's GEMM plan either way), ln_qkv takes any even width; a width
    that is not a multiple of 8 is refused by flash_attn's plan and by
    attn_proj_residual's gate."""
    c = hd * heads
    assert tglobal.ln_qkv_plan(4096, c, 3 * c, SMS).gemm.bm in tmlp.GEMM_ROWS
    plan = tglobal.proj_res_plan(4096, c, SMS)
    assert plan == tmlp.gemm_tile(4096, c, SMS)
    if hd % 8:
        with pytest.raises(build.KernelError):
            tflash.flash_plan(16 * heads, 256, 256, hd, SMS)
        with pytest.raises(build.KernelError):
            tglobal.proj_a_width(hd)
        return
    width = tflash.flash_plan(16 * heads, 256, 256, hd, SMS).width
    assert width == min(w for w in tflash.TC_WIDTHS if w >= hd)
    assert tglobal.proj_a_width(hd) == (hd if hd in tglobal.PROJ_HEAD_WIDTHS else 0)


@pytest.mark.parametrize("hd", [0, 4, 12, 100])
def test_proj_a_width_refuses_widths_off_16_bytes(hd):
    with pytest.raises(build.KernelError):
        tglobal.proj_a_width(hd)
