"""The float32 `mlp_block`, `window_attn_block` and `qpool_attn_block`
kernels' arithmetic, emulated on the CPU, and their launch plans.

The kernels (csrc/tf32.cuh) take every float32 product as three TF32
products: x split into hi = tf32(x), rounded to nearest (ties away, as
cvt.rna) at a 10-bit mantissa, and lo = x − hi, which the tensor core
reads as TF32 by dropping its low 13 bits; a·b as lo·hi + hi·lo + hi·hi
accumulated in float32. One TF32 product rounds each operand to nearest.
This file emulates both on the float32 bits (the products of TF32
values, exact in float64, summed in float64), and shows
at Hiera-t@512's shapes, from seeded numpy inputs, that one TF32 product
misses the float32 kernel gate — 1e-4 · max(1, max |plain|), as
chip_smoke.tolerance("float32") — and the three hold it; and, at small
shapes, that the emulated kernels hold the JAX package's Pallas kernels
(interpret mode) within the gates of tests/test_torch_port_kernels.py.
The launch plans, the float32 window and q-pool routes and their shared
memory are checked against the values the wrappers' rules give, written
down here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from circuitvision_tpu.ops.pallas.mlp_block import mlp_block as pallas_mlp
from circuitvision_tpu.ops.pallas.window_attn import qpool_attn_block as pallas_qpool
from circuitvision_tpu.ops.pallas.window_attn import window_attn_block as pallas_window
from circuitvision_tpu_torch.ops.cuda import build
from circuitvision_tpu_torch.ops.cuda import mlp_block as tmlp
from circuitvision_tpu_torch.ops.cuda import window_attn as twin
from circuitvision_tpu_torch.ops.cuda.global_attn import pool2x2_windows

#: the float32 kernel gate, relative to max(1, max |plain|)
GATE = 1e-4
#: (T, C) of the four mlp_block shapes of Hiera-t@512 (stages at 128²,
#: 64², 32², 16² tokens)
T512_MLP = [(16384, 96), (4096, 192), (1024, 384), (256, 768)]
#: (windows, T, C, heads) of its two window-attention shapes (stage 1 at
#: 128², windows of 8 × 8; stage 2 at 64², windows of 4 × 4)
T512_WINDOW = [(256, 64, 96, 1), (256, 16, 192, 2)]
#: (windows, win, C_in, C_out, heads) of its two q-pool transitions
T512_QPOOL = [(256, 8, 96, 192, 2), (256, 4, 192, 384, 4)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10-bit mantissa), to nearest, ties away
    from zero: add half of the 13 dropped bits' weight to the magnitude
    bits, then clear them."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def truncated(x: torch.Tensor) -> torch.Tensor:
    """float32 as the tensor core reads it in a TF32 product: its low 13
    bits dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, truncated(x - hi)


def matmul(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b (batched) as the kernels take it: `terms` 1 — one TF32
    product; 3 — lo·hi + hi·lo + hi·hi."""
    ah, al = split(a)
    bh, bl = split(b)
    out = ah.double() @ bh.double()
    if terms == 3:
        out = out + ah.double() @ bl.double() + al.double() @ bh.double()
    return out.float()


def linear(x, w, b, terms):
    return matmul(x, w.t(), terms) + b


def mlp_emulated(x, lns, lnb, w0, b0, w1, b1, terms):
    xn = tmlp.layernorm_f32(x, lns, lnb, 1e-6)
    h = F.gelu(linear(xn, w0, b0, terms))
    return x + b1 + matmul(h, w1.t(), terms)


def window_emulated(x, lns, lnb, wqkv, bqkv, wp, bp, heads, terms):
    """The float32 window block as launch_window_f32 computes it: q|k|v
    with its bias, attention over each window with f32 scores and
    softmax, x + (o·Wprojᵀ + b)."""
    nw, t, c = x.shape
    hd = c // heads
    xn = tmlp.layernorm_f32(x, lns, lnb, 1e-6)
    qkv = linear(xn, wqkv, bqkv, terms).view(nw, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    p = torch.softmax(matmul(q, k.transpose(-1, -2), terms) * hd ** -0.5, dim=-1)
    o = matmul(p, v, terms).transpose(1, 2).reshape(nw, t, c)
    return x + linear(o, wp, bp, terms)


def qpool_emulated(x, lns, lnb, wsk, bsk, wqkv, bqkv, wp, bp, heads, win, terms):
    """The float32 q-pool block as launch_qpool_f32 computes it: skip and
    q pooled after their bias, attention with f32 scores and softmax, the
    projection added to the pooled skip."""
    t = win * win
    nw, co = x.shape[0] // t, wp.shape[0]
    hd = co // heads
    xn = tmlp.layernorm_f32(x, lns, lnb, 1e-6)
    skip = pool2x2_windows(linear(xn, wsk, bsk, terms).view(nw, t, co), win).reshape(-1, co)
    qkv = linear(xn, wqkv, bqkv, terms)
    q = pool2x2_windows(qkv[:, :co].reshape(nw, t, co), win)
    heads_of = lambda a: a.reshape(nw, -1, heads, hd).transpose(1, 2)  # noqa: E731
    q, k, v = heads_of(q), heads_of(qkv[:, co:2 * co]), heads_of(qkv[:, 2 * co:])
    p = torch.softmax(matmul(q, k.transpose(-1, -2), terms) * hd ** -0.5, dim=-1)
    o = matmul(p, v, terms).transpose(1, 2).reshape(-1, co)
    return skip + linear(o, wp, bp, terms)


def _rnd(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _mlp_args(rng, t, c):
    h = 4 * c
    return (_rnd(rng, t, c), 1 + _rnd(rng, c, scale=0.1), _rnd(rng, c, scale=0.1),
            _rnd(rng, h, c, scale=c ** -0.5), _rnd(rng, h, scale=0.02),
            _rnd(rng, c, h, scale=h ** -0.5), _rnd(rng, c, scale=0.02))


def _window_args(rng, nw, t, c):
    return (_rnd(rng, nw, t, c), 1 + _rnd(rng, c, scale=0.1), _rnd(rng, c, scale=0.1),
            _rnd(rng, 3 * c, c, scale=c ** -0.5), _rnd(rng, 3 * c, scale=0.02),
            _rnd(rng, c, c, scale=c ** -0.5), _rnd(rng, c, scale=0.02))


def _qpool_args(rng, nw, win, ci, co):
    return (_rnd(rng, nw * win * win, ci), 1 + _rnd(rng, ci, scale=0.1),
            _rnd(rng, ci, scale=0.1), _rnd(rng, co, ci, scale=ci ** -0.5),
            _rnd(rng, co, scale=0.02), _rnd(rng, 3 * co, ci, scale=ci ** -0.5),
            _rnd(rng, 3 * co, scale=0.02), _rnd(rng, co, co, scale=co ** -0.5),
            _rnd(rng, co, scale=0.02))


def _rel_err(got, ref):
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


# ------------------------------------------------------------- the split
def test_split_is_exact_and_rounds_to_nearest():
    """hi and lo carry 11 significant bits each (low 13 bits clear), hi +
    lo is x to within 2^-21 of |x|, and hi's rounding is to nearest with
    ties away from zero."""
    x = _rnd(np.random.default_rng(0), 4096, scale=100.0)
    hi, lo = split(x)
    assert not ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).any()
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((hi.double() + lo.double() - x.double()).abs() <= x.abs().double() * 2.0 ** -21).all()
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -11 - 2.0 ** -23])
    assert tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]


# ----------------------------------------------- one TF32 product against three
@pytest.mark.parametrize("t,c", T512_MLP)
def test_mlp_one_tf32_misses_three_hold(t, c):
    args = _mlp_args(np.random.default_rng(0), t, c)
    ref = tmlp.mlp_block_plain(*args)
    assert _rel_err(mlp_emulated(*args, terms=1), ref) > GATE
    assert _rel_err(mlp_emulated(*args, terms=3), ref) <= GATE / 100


@pytest.mark.parametrize("nw,t,c,heads", T512_WINDOW)
def test_window_one_tf32_misses_three_hold(nw, t, c, heads):
    args = _window_args(np.random.default_rng(0), nw, t, c)
    ref = twin.window_attn_block_plain(*args, heads=heads)
    assert _rel_err(window_emulated(*args, heads, terms=1), ref) > GATE
    assert _rel_err(window_emulated(*args, heads, terms=3), ref) <= GATE / 100


@pytest.mark.parametrize("nw,win,ci,co,heads", T512_QPOOL)
def test_qpool_one_tf32_misses_three_hold(nw, win, ci, co, heads):
    args = _qpool_args(np.random.default_rng(0), nw, win, ci, co)
    ref = twin.qpool_attn_block_plain(*args, heads=heads, win=win)
    assert _rel_err(qpool_emulated(*args, heads, win, terms=1), ref) > GATE
    assert _rel_err(qpool_emulated(*args, heads, win, terms=3), ref) <= GATE / 100


# --------------------------------------------- against the JAX package
@pytest.fixture()
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.usefixtures("_exact_matmuls")
def test_mlp_emulated_matches_pallas():
    """The kernel's 3×TF32 MLP against the Pallas mlp_block (Flax
    layout: weights (in, out)) on the same inputs."""
    args = _mlp_args(np.random.default_rng(1), 96, 96)
    x, lns, lnb, w0, b0, w1, b1 = (a.numpy() for a in args)
    ref = np.asarray(pallas_mlp(*map(jnp.asarray, (x, lns, lnb, w0.T, b0, w1.T, b1)),
                                row_tile=32, hidden_chunk=192, interpret=True))
    got = mlp_emulated(*args, terms=3).numpy()
    assert np.abs(got - ref).max() <= GATE * max(1.0, np.abs(ref).max())


@pytest.mark.usefixtures("_exact_matmuls")
@pytest.mark.parametrize("nw,t,c,heads", [(4, 16, 192, 2), (2, 64, 144, 2)])
def test_window_emulated_matches_pallas(nw, t, c, heads):
    """The kernel's 3×TF32 window block against the Pallas
    window_attn_block (Flax layout) at T = 16, head width 96, and T = 64,
    head width 72."""
    args = _window_args(np.random.default_rng(3), nw, t, c)
    x, lns, lnb, wqkv, bqkv, wp, bp = (a.numpy() for a in args)
    ref = np.asarray(pallas_window(*map(jnp.asarray, (x, lns, lnb, wqkv.T, bqkv, wp.T, bp)),
                                   heads=heads, gw=nw // 2, interpret=True))
    got = window_emulated(*args, heads, terms=3).numpy()
    assert np.abs(got - ref).max() <= GATE * max(1.0, np.abs(ref).max())


@pytest.mark.usefixtures("_exact_matmuls")
@pytest.mark.parametrize("nw,win,ci,co,heads", [(2, 8, 96, 192, 2), (4, 4, 96, 192, 2)])
def test_qpool_emulated_matches_pallas(nw, win, ci, co, heads):
    """The kernel's 3×TF32 q-pool block against the Pallas
    qpool_attn_block at both window sizes, head width 96."""
    args = _qpool_args(np.random.default_rng(2), nw, win, ci, co)
    x, lns, lnb, wsk, bsk, wqkv, bqkv, wp, bp = (a.numpy() for a in args)
    ref = np.asarray(pallas_qpool(*map(jnp.asarray, (x, lns, lnb, wsk.T, bsk, wqkv.T, bqkv,
                                                     wp.T, bp)),
                                  heads=heads, win=win, interpret=True))
    got = qpool_emulated(*args, heads, win, terms=3).numpy()
    assert np.abs(got - ref).max() <= GATE * max(1.0, np.abs(ref).max())


# ------------------------------------------------------------ launch plans
#: (T, C) → ((depth splits, blocks) of h = GELU(xn·W0ᵀ + b0), the same
#: of out = x + b1 + h·W1ᵀ, workspace floats) on 132 SMs: t@512 and the
#: float32 L@1024 shapes (phase 6)
MLP_PLANS = {
    (16384, 96): ((1, 1536), (1, 512), 7864320),
    (4096, 192): ((1, 768), (1, 192), 3932160),
    (1024, 384): ((1, 384), (3, 288), 3145728),
    (256, 768): ((1, 192), (6, 288), 2162688),
    (65536, 144): ((1, 9216), (1, 3072), 47185920),
    (16384, 288): ((1, 4608), (1, 1280), 23592960),
    (4096, 576): ((1, 2304), (1, 576), 11796480),
    (1024, 1152): ((1, 1152), (1, 288), 5898240),
}


@pytest.mark.parametrize("t,c", sorted(MLP_PLANS))
def test_mlp_plan_f32(t, c):
    plan = tmlp.mlp_plan_f32(t, c, 4 * c, 132)
    g1, g2, ws = MLP_PLANS[(t, c)]
    assert (plan.gemm1.splits, plan.gemm1.blocks) == g1
    assert (plan.gemm2.splits, plan.gemm2.blocks) == g2
    assert plan.workspace == ws
    assert tmlp.F32_GEMM_SMEM == 55296 <= build.MAX_SMEM


#: (rows, C, heads) → (q|k|v GEMM (splits, blocks), projection GEMM,
#: attention blocks' shared memory, workspace floats) on 132 SMs: t@512,
#: the float32 L@1024 window shapes (phase 6) and the card tests' ragged
#: (5, 32, 112, 2) and (7, 16, 288, 4), the last with both depths split
WINDOW_PLANS = {
    (16384, 96, 1): ((1, 1280), (1, 512), 51200, 7864320),
    (4096, 192, 2): ((1, 576), (1, 192), 51200, 3932160),
    (65536, 144, 2): ((1, 7168), (1, 3072), 51200, 47185920),
    (16384, 288, 4): ((1, 3584), (1, 1280), 51200, 23592960),
    (1024, 1152, 16): ((1, 864), (1, 288), 51200, 5898240),
    (160, 112, 2): ((1, 18), (1, 6), 34816, 89600),
    (112, 288, 4): ((2, 56), (2, 20), 51200, 354816),
}


@pytest.mark.parametrize("shape", sorted(WINDOW_PLANS))
def test_window_plan_f32(shape):
    plan = twin.window_plan_f32(*shape, 132)
    g_qkv, g_p, attn_smem, ws = WINDOW_PLANS[shape]
    assert (plan.gemm_qkv.splits, plan.gemm_qkv.blocks) == g_qkv
    assert (plan.gemm_proj.splits, plan.gemm_proj.blocks) == g_p
    assert (plan.attn_smem, plan.workspace) == (attn_smem, ws)
    # four attention blocks share an SM's 228 KB (1 KB of it reserved a block)
    assert 4 * (plan.attn_smem + 1024) <= 228 * 1024


#: (rows, C_in, C_out, heads) → (input GEMM (splits, blocks), projection
#: GEMM, attention blocks' shared memory, workspace floats)
QPOOL_PLANS = {
    (16384, 96, 192, 2): ((1, 3072), (1, 192), 52736, 10223616),
    (4096, 192, 384, 4): ((1, 1536), (3, 288), 52736, 6291456),
    (65536, 144, 288, 4): ((1, 18432), (1, 1280), 44544, 61341696),
    (16384, 288, 576, 8): ((1, 9216), (1, 576), 44544, 30670848),
}


@pytest.mark.parametrize("shape", sorted(QPOOL_PLANS))
def test_qpool_plan_f32(shape):
    plan = twin.qpool_plan_f32(*shape, 132)
    g_in, g_p, attn_smem, ws = QPOOL_PLANS[shape]
    assert (plan.gemm_in.splits, plan.gemm_in.blocks) == g_in
    assert (plan.gemm_proj.splits, plan.gemm_proj.blocks) == g_p
    assert (plan.attn_smem, plan.workspace) == (attn_smem, ws)
    # four attention blocks share an SM's 228 KB (1 KB of it reserved a block)
    assert 4 * (plan.attn_smem + 1024) <= 228 * 1024


def test_f32_splits_are_the_kernels():
    """A plan's split count is the one the kernel's whole-tile split of
    the depth gives back (csrc/tf32.cuh split_len), each split at least
    F32_MIN_SPLIT_TILES tiles deep where it splits, so the partial
    workspace the wrapper sizes is the one the kernel fills."""
    for m in (16, 100, 256, 1000, 1024, 4096):
        for n in (96, 384, 768, 1152):
            for k in (96, 100, 384, 1536, 3072):
                g = tmlp.f32_gemm_plan(m, n, k, 132)
                tiles = -(-k // tmlp.F32_GEMM_BK)
                k_len = -(-tiles // g.splits) * tmlp.F32_GEMM_BK
                assert -(-k // k_len) == g.splits
                if g.splits > 1:
                    assert k_len >= tmlp.F32_MIN_SPLIT_TILES * tmlp.F32_GEMM_BK


#: (tokens, C_in, C_out, heads) → float32 route; the q-pool block's
#: shared memory is its GEMM's whatever the shape
QPOOL_ROUTES_F32 = {
    (64, 96, 192, 2): "block",      # t@512 win 8
    (16, 192, 384, 4): "block",     # t@512 win 4
    (64, 144, 288, 4): "block",     # L@1024 win 8, head width 72
    (16, 288, 576, 8): "block",     # L@1024 win 4
    (256, 576, 1152, 16): "tiled",  # L@1024 win 16
    (36, 96, 192, 2): "tiled",      # win 6: no pool group in an m16 tile
    (16, 192, 256, 4): "tiled",     # head width 64: no attention instance
    (16, 190, 384, 4): "tiled",     # C_in off a multiple of 4
}


#: (tokens, C, heads) → float32 window route; the block's shared memory
#: is its GEMM's whatever the shape
WINDOW_ROUTES_F32 = {
    (64, 96, 1): "block",      # t@512 stage 1
    (16, 192, 2): "block",     # t@512 stage 2
    (64, 144, 2): "block",     # L@1024 stage 1, head width 72
    (16, 288, 4): "block",     # L@1024 stage 2
    (64, 1152, 16): "block",   # L@1024 stage 4
    (32, 112, 2): "block",     # head width 56
    (256, 576, 8): "tiled",    # L@1024 stage 3: 256 tokens
    (36, 96, 1): "tiled",      # windows of 6 × 6
    (16, 128, 2): "tiled",     # head width 64: no attention instance
    (64, 100, 1): "tiled",     # head width 100
}


@pytest.mark.parametrize("shape", sorted(WINDOW_ROUTES_F32))
def test_window_route_f32(shape):
    tokens, c, heads = shape
    assert twin.window_smem("window", tokens, c, c, torch.float32) == tmlp.F32_GEMM_SMEM
    assert twin.window_route("window", tokens, c, c, heads, torch.float32) == \
        WINDOW_ROUTES_F32[shape]


@pytest.mark.parametrize("shape", sorted(QPOOL_ROUTES_F32))
def test_qpool_route_f32(shape):
    tokens, ci, co, heads = shape
    assert twin.window_smem("qpool", tokens, ci, co, torch.float32) == tmlp.F32_GEMM_SMEM
    assert twin.window_route("qpool", tokens, ci, co, heads, torch.float32) == \
        QPOOL_ROUTES_F32[shape]
