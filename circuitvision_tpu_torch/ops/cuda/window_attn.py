"""Hiera windowed-attention halves as kernels: in bfloat16 one block per
64 or 128 rows of windows, in float32 an LN pre-pass, GEMMs and an
attention kernel over a workspace.

Replaces two Pallas kernels of the JAX package
(circuitvision_tpu/ops/pallas/window_attn.py):

  * `window_attn_block`: out = x + proj(softmax(q·kᵀ·s)·v) with
    qkv = W·LN1(x), over (n_windows, T, C) windows;
  * `qpool_attn_block`: the stage-transition block — xn = LN1(x),
    skip = maxpool2×2(xn·Wskip + b), q = maxpool2×2(q(xn)), k and v from
    xn, out = skip + proj(attention) — over window-major rows, emitting
    win²/4 rows per window.

The CUDA source is csrc/window_attn.cu; its header note says what bounds
the kernels on the H100 and how the design answers that. In bfloat16
both run their products and their attention on the tensor cores:
`window_attn_block` on mma.sync, a block owning 64 rows (64 / T windows
of T ∈ {16, 32, 64}); `qpool_attn_block` as an LN pre-pass into a bf16
workspace and a block owning 128 rows (eight windows of win 4 or two of
win 8) that runs its input-side products on wgmma with xn in registers,
pools skip and q in the accumulators and takes its heads two at a time.
In float32 both run as four launches with every product 3×TF32 on
mma.sync (csrc/tf32.cuh): an LN pre-pass into an f32 workspace, one GEMM
for q, k and v (for `qpool_attn_block` with skip, skip and q pooled in
the accumulators), attention per (16 query rows, head) — for
`window_attn_block` against the rows' own window only — and the
projection GEMM with the residual (`window_plan_f32` and
`qpool_plan_f32` pick the GEMMs' depth splits).
The plain versions beside them compute the same functions with the
kernels' numerics: f32 LayerNorm statistics, f32 scores and softmax
scaled by 1/sqrt(head width), products accumulated in f32, and values
rounded to the compute dtype where the kernel stores them.

A window that does not fit the one-block kernel (`window_route`: its
shared memory in the dtype, and the shapes and head widths the kernels
are built for: the bf16 kernels and the float32 blocks take head widths
of TC_HEAD_WIDTHS; the Hiera-L stage-3 and stage-4 windows and its
last q-pool transition) takes the tiled route
instead, which computes the same function with three kernels batched
over the windows: `ln_qkv`, `flash_attn` and `attn_proj_residual`
(ops/cuda/global_attn.py, ops/cuda/flash_attn.py), rounding q/k/v, the
attention output and the projection where the one-block kernels do. In
bfloat16 its kernels copy heads in 16-byte pieces, so a head width off a
multiple of 8 runs padded (`pad_heads`): each head's q/k/v weight rows
get zero rows up to the next multiple of 8, so q, k and v carry zero
columns that change no score; flash_attn takes its softmax scale from
the true width, and the projection reads the padded heads through
weight columns that are zero at the padding, its output widened to the
padded width and cut back to C after the residual.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from .build import (
    MAX_SMEM, KernelError, check, check_aligned, check_ln_params, check_no_grad, check_operands,
    library, sm_count, stream_ptr,
)
from .flash_attn import flash_attn
from .global_attn import attn_proj_residual, ln_qkv, pool2x2_windows
from .mlp_block import F32_GEMM_SMEM, H100_SMS, F32Gemm, f32_gemm_plan, layernorm_f32

#: the bf16 window kernel (csrc/window_attn.cu window_tc_kernel): rows a
#: block owns, weight rows a staged tile holds, the window sizes it packs
#: into its rows, and the head widths it is built for (Hiera-b+, -L and
#: -t/-s)
TC_ROWS, TC_BN = 64, 48
TC_TOKENS = (16, 32, 64)
TC_HEAD_WIDTHS = (56, 72, 96)
#: the bf16 q-pool kernel (qpool_tc_kernel): window sizes (win 4 and 8),
#: input and pooled rows a block owns, columns of a head group (two
#: heads of ≤ 96), weight rows of a staged input tile, stages of both
#: weight rings, depth of a staged Wproj tile, the input widths it is
#: built for (the t/s and L transitions'; its depth is a compile-time
#: constant) and the widest output (8 warps × 18 units of 8 over two row
#: tiles)
TC_QPOOL_TOKENS = (16, 64)
TC_QPOOL_ROWS, TC_QPOOL_OUT, TC_QPOOL_GROUP = 128, 32, 2 * 96
TC_QPOOL_BN, TC_QPOOL_STAGES, TC_QPOOL_PROJ_K = 32, 3, 32
TC_QPOOL_WIDTHS_IN, TC_QPOOL_MAX_OUT = (96, 144, 192, 288), 576
#: the float32 q-pool block (csrc/window_attn.cu launch_qpool_f32): the
#: input rows (keys) behind one 16-row tile of pooled queries, an
#: attention block each (with one head)
QPOOL_F32_UNIT = 64
#: the float32 window block (launch_window_f32): the rows behind one
#: attention block (whole windows of TC_TOKENS, 16 query rows a warp),
#: one head each
WINDOW_F32_ROWS = 64


def _ld4(hd: int) -> int:
    """A head's row stride in floats, ≡ 4 (mod 32): the eight rows one
    ldmatrix reads fall in distinct bank groups."""
    return hd + (36 - hd % 32) % 32


def window_attn_f32_smem(hd: int) -> int:
    """Shared-memory bytes of the float32 window block's attention block
    at head width hd (csrc/window_attn.cu WinAttnF32): the head's k and v
    rows of its 64 rows, each at a stride ≡ 4 (mod 32) floats."""
    return 4 * 2 * WINDOW_F32_ROWS * _ld4(hd)


def qpool_attn_f32_smem(hd: int) -> int:
    """Shared-memory bytes of the float32 q-pool's attention block at head
    width hd (csrc/window_attn.cu QpAttnF32): the head's 64 k rows at a
    stride ≡ 4 (mod 32) floats (P over them once S is done), its 64 v rows
    at one ≡ 8, and the four warps' row maxima and sums."""
    ldk, ldv = _ld4(hd), hd + (40 - hd % 32) % 32
    return 4 * (QPOOL_F32_UNIT * (ldk + ldv) + 2 * 4 * 16)


def window_smem(kind: str, tokens: int, c_in: int, c_out: int,
                dtype: torch.dtype = torch.float32) -> int:
    """Shared-memory bytes of the one-block kernel for a `tokens`-token
    window ("window": width c_in == c_out; "qpool": c_in → c_out) in
    `dtype`, as csrc/window_attn.cu's cv_window_attn_smem and
    cv_qpool_attn_smem give them. The bf16 kernels hold 64
    (window) or 128 (q-pool) rows whatever the window size, in bf16, each
    row padded by 16 bytes: the window kernel xn, q|k|v and two staged
    weight tiles; the q-pool kernel its attention output and three
    staged weight tiles and its biases, beside them xn (from its LN
    pre-pass) until the warps hold it in registers, then one head group's
    pooled q and k|v, and at the end three staged Wproj tiles over tiles
    and group. The float32 blocks' largest block is their 3×TF32 GEMM's,
    whatever the shape (`window_attn_f32_smem` and `qpool_attn_f32_smem`
    for their attention blocks)."""
    if dtype == torch.bfloat16 and kind == "window":
        return 2 * ((TC_ROWS + 2 * TC_BN) * (c_in + 8) + TC_ROWS * (3 * c_in + 8))
    if dtype == torch.bfloat16 and kind == "qpool":
        ring = TC_QPOOL_STAGES * -(-c_in // 64) * TC_QPOOL_BN * 128  # swizzled 64-deep panels
        group = 2 * max(TC_QPOOL_ROWS * (c_in + 8),
                        TC_QPOOL_OUT * (TC_QPOOL_GROUP + 8) + TC_QPOOL_ROWS * (2 * TC_QPOOL_GROUP + 8))
        proj = 2 * TC_QPOOL_STAGES * c_out * (TC_QPOOL_PROJ_K + 8)
        keep = 2 * (TC_QPOOL_OUT * (c_out + 8) + 4 * c_out)
        return keep + 1024 + max(ring + group, proj)
    if kind not in ("window", "qpool"):
        raise ValueError(f"unknown window kind {kind!r}")
    return F32_GEMM_SMEM


def block_heads(kind: str, c_out: int, heads: int) -> bool:
    """Whether the bf16 block kernel of `kind` is built for `heads` heads
    over c_out columns: a head width of TC_HEAD_WIDTHS (its template
    instances), C a multiple of 16, and for the q-pool kernel an even
    number of heads (it takes them two at a time)."""
    return c_out % heads == 0 and c_out // heads in TC_HEAD_WIDTHS and c_out % 16 == 0 \
        and (kind == "window" or heads % 2 == 0)


def window_route(kind: str, tokens: int, c_in: int, c_out: int, heads: int,
                 dtype: torch.dtype = torch.float32) -> str:
    """"block" where one window fits the one-block kernel — its shared
    memory in `dtype` and, for the bf16 kernels, a share of their 64 rows
    (window: T ∈ {16, 32, 64}; q-pool: win 4 or 8, C_in one of
    TC_QPOOL_WIDTHS_IN, C_out ≤ 576) and a head layout they are built for
    (`block_heads`); for the float32 blocks the window block's T or the
    q-pool block's win 4 or 8 (C_in a multiple of 4) and a head width of
    TC_HEAD_WIDTHS (their attention kernels' instances, any number of
    heads) — else "tiled". The tiled
    route's kernels take any head width that is a multiple of 8 up to
    256 (flash_attn pads it to
    TC_WIDTHS, attn_proj_residual reads it through a runtime-width layout
    outside PROJ_HEAD_WIDTHS); in bfloat16 a width off a multiple of 8
    runs padded (`pad_heads`), up to flash_attn's widest, 256."""
    if dtype == torch.bfloat16 and (
            (kind == "window" and tokens not in TC_TOKENS)
            or (kind == "qpool" and (tokens not in TC_QPOOL_TOKENS
                                     or c_in not in TC_QPOOL_WIDTHS_IN
                                     or c_out > TC_QPOOL_MAX_OUT))
            or not block_heads(kind, c_out, heads)):
        return "tiled"
    if dtype == torch.float32 and (
            (kind == "window" and tokens not in TC_TOKENS)
            or (kind == "qpool" and (tokens not in TC_QPOOL_TOKENS or c_in % 4))
            or c_out % heads or c_out // heads not in TC_HEAD_WIDTHS):
        return "tiled"
    return "block" if window_smem(kind, tokens, c_in, c_out, dtype) <= MAX_SMEM else "tiled"


@dataclasses.dataclass(frozen=True)
class QpoolPlanF32:
    """Launch plan of the float32 q-pool block over `rows` input rows: the
    input GEMM (skip, q, k and v; no split, its epilogue pools whole
    fragments), the projection GEMM over the rows / 4 pooled rows, the
    attention blocks' shared memory, and the f32 workspace's elements —
    xn, pooled skip, pooled q, k | v, the attention output, the
    projection's partial sums (csrc/window_attn.cu launch_qpool_f32)."""

    gemm_in: F32Gemm
    gemm_proj: F32Gemm
    attn_smem: int
    workspace: int


@functools.lru_cache(maxsize=64)
def qpool_plan_f32(rows: int, c_in: int, c_out: int, heads: int,
                   sms: int = H100_SMS) -> QpoolPlanF32:
    out_rows = rows // 4
    g_in = f32_gemm_plan(rows, 4 * c_out, c_in, sms, split=False)
    g_p = f32_gemm_plan(out_rows, c_out, c_out, sms)
    partial = g_p.splits * out_rows * c_out if g_p.splits > 1 else 0
    return QpoolPlanF32(g_in, g_p, qpool_attn_f32_smem(c_out // heads),
                        rows * c_in + 3 * out_rows * c_out + 2 * rows * c_out + partial)


@dataclasses.dataclass(frozen=True)
class WindowPlanF32:
    """Launch plan of the float32 window block over `rows` rows of width
    C: the q|k|v GEMM, the projection GEMM, the attention blocks' shared
    memory, and the f32 workspace's elements — xn, q|k|v, the attention
    output, the larger of the two GEMMs' partial sums
    (csrc/window_attn.cu launch_window_f32)."""

    gemm_qkv: F32Gemm
    gemm_proj: F32Gemm
    attn_smem: int
    workspace: int


@functools.lru_cache(maxsize=64)
def window_plan_f32(rows: int, c: int, heads: int, sms: int = H100_SMS) -> WindowPlanF32:
    g_qkv = f32_gemm_plan(rows, 3 * c, c, sms)
    g_p = f32_gemm_plan(rows, c, c, sms)
    partial = max(g.splits * rows * n if g.splits > 1 else 0
                  for g, n in ((g_qkv, 3 * c), (g_p, c)))
    return WindowPlanF32(g_qkv, g_p, window_attn_f32_smem(c // heads), 5 * rows * c + partial)


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dt) -> torch.Tensor:
    """x·wᵀ + b accumulated in f32, rounded to dt."""
    return (x.float() @ w.float().t() + b.float()).to(dt)


def _attention(q, k, v, scale: float, dt) -> torch.Tensor:
    """(B, Nq, H, D) × (B, Nk, H, D) softmax attention: f32 scores and
    softmax, probabilities in dt, p·v in f32 rounded to dt."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(dt)


def window_attn_block_plain(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                            heads, eps=1e-6):
    dt = x.dtype
    nw, t, c = x.shape
    xn = layernorm_f32(x, ln_scale, ln_bias, eps).to(dt)
    qkv = _linear(xn, wqkv, bqkv, dt).view(nw, t, 3, heads, c // heads)
    o = _attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], (c // heads) ** -0.5, dt)
    return x + _linear(o.reshape(nw, t, c), wproj, bproj, dt)


def window_attn_block(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                      heads, eps=1e-6, ln_width=None):
    """x (n_windows, T, C); wqkv (3C, C), wproj (C, C) in torch Linear
    layout. CPU tensors take the plain version; CUDA tensors launch the
    block kernels — bfloat16: one block per 64 rows; float32: the LN
    pre-pass, the q|k|v GEMM, the window attention and the projection
    GEMM, 3×TF32, over a workspace (`window_plan_f32`), counted as one
    launch — or, where the route rule gives no block kernel, take the
    tiled route (counted in `window_attn_block.tiled`). Rows zero-padded past
    their true width `ln_width` (a bfloat16 block off a multiple of 8,
    hiera.pad_block; wqkv's columns and the LN parameters padded with
    them, wproj at the true width) take the tiled route on both devices,
    whose LayerNorm divides by the true width."""
    if ln_width is not None:
        window_attn_block.tiled += x.is_cuda
        return window_attn_block_tiled(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                                       heads, eps, ln_width=ln_width)
    if x.device.type == "cpu":
        return window_attn_block_plain(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                                       bproj, heads, eps)
    check_operands("window_attn_block", x, wqkv, bqkv, wproj, bproj)
    check_no_grad("window_attn_block", x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj)
    check_ln_params("window_attn_block", x, ln_scale, ln_bias)
    nw, t, c = x.shape
    if wqkv.shape != (3 * c, c) or wproj.shape != (c, c) or c % heads:
        raise KernelError("window_attn_block: weight shapes do not match x")
    if window_route("window", t, c, c, heads, x.dtype) == "tiled":
        window_attn_block.tiled += 1
        return window_attn_block_tiled(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                                       heads, eps)
    lib = library("window_attn")
    out = torch.empty_like(x)
    args = (x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(), out.data_ptr())
    if x.dtype == torch.bfloat16:
        check_aligned("window_attn_block", x, wqkv, wproj)
        err = lib.cv_window_attn_bf16(*args, nw, t, c, heads, eps, stream_ptr(x))
    else:
        plan = window_plan_f32(nw * t, c, heads, sm_count(x))
        ws = torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
        err = lib.cv_window_attn_f32(*args, ws.data_ptr(), nw, t, c, heads, eps,
                                     plan.gemm_qkv.splits, plan.gemm_proj.splits, stream_ptr(x))
    check(err, "window_attn_block")
    window_attn_block.launches += 1
    return out


window_attn_block.launches = 0
window_attn_block.tiled = 0


def padded_head_width(hd: int, dtype: torch.dtype) -> int:
    """The head width the tiled route computes at: in bfloat16 hd rounded
    up to a multiple of 8, in float32 hd (its kernels take any width)."""
    return -(-hd // 8) * 8 if dtype == torch.bfloat16 else hd


def pad_heads(wqkv, bqkv, wproj, bproj, heads: int, dtype: torch.dtype):
    """(hd, wqkv, bqkv, wproj, bproj) for the tiled route at head width
    hp = padded_head_width(hd): each head's rows of wqkv (slabs · heads ·
    hd, C_in) and bqkv followed by hp − hd zero rows; wproj (C, C)
    widened to (heads·hp, heads·hp) — each head's hd input columns
    followed by zero columns, zero output rows past C — and bproj to
    heads·hp. The same tensors where hp == hd."""
    c = wproj.shape[0]
    hd = c // heads
    hp = padded_head_width(hd, dtype)
    if hp == hd:
        return hd, wqkv, bqkv, wproj, bproj
    cp, c_in = heads * hp, wqkv.shape[1]
    groups = wqkv.shape[0] // hd
    wq = F.pad(wqkv.reshape(groups, hd, c_in), (0, 0, 0, hp - hd)).reshape(groups * hp, c_in)
    bq = F.pad(bqkv.reshape(groups, hd), (0, hp - hd)).reshape(groups * hp)
    wp = F.pad(wproj.reshape(c, heads, hd), (0, hp - hd)).reshape(c, cp)
    return hd, wq, bq, F.pad(wp, (0, 0, 0, cp - c)), F.pad(bproj, (0, cp - c))


def window_attn_block_tiled(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                            heads, eps=1e-6, round_proj=True, ln_width=None):
    """window_attn_block as ln_qkv → flash_attn → attn_proj_residual over
    (B, N, C) windows — or one global block, B images of N tokens — with
    the heads padded where the dtype needs it (`pad_heads`). `round_proj`
    rounds the projection before the residual add, as the window kernels
    do; the global blocks do not. `ln_width`: see window_attn_block."""
    c = x.shape[-1]
    hd, wqkv, bqkv, wproj, bproj = pad_heads(wqkv, bqkv, wproj, bproj, heads, x.dtype)
    pad = wproj.shape[0] - c
    q, k, v = ln_qkv(x, ln_scale, ln_bias, wqkv, bqkv, heads, eps=eps, ln_width=ln_width)
    out = attn_proj_residual(F.pad(x, (0, pad)) if pad else x,
                             flash_attn(q, k, v, scale_width=hd), wproj, bproj,
                             round_proj=round_proj)
    return out[..., :c].contiguous() if pad else out


def qpool_attn_block_plain(x, ln_scale, ln_bias, wskip, bskip, wqkv, bqkv,
                           wproj, bproj, heads, win, eps=1e-6):
    dt = x.dtype
    t = win * win
    nw, c_out = x.shape[0] // t, wproj.shape[0]
    hd = c_out // heads
    xn = layernorm_f32(x, ln_scale, ln_bias, eps).to(dt)
    skip = pool2x2_windows(_linear(xn, wskip, bskip, dt).view(nw, t, c_out), win)
    qkv = _linear(xn, wqkv, bqkv, dt)
    q = pool2x2_windows(qkv[:, :c_out].reshape(nw, t, c_out), win).view(nw, t // 4, heads, hd)
    k = qkv[:, c_out : 2 * c_out].reshape(nw, t, heads, hd)
    v = qkv[:, 2 * c_out :].reshape(nw, t, heads, hd)
    o = _attention(q, k, v, hd ** -0.5, dt).reshape(nw * t // 4, c_out)
    return skip.reshape(-1, c_out) + _linear(o, wproj, bproj, dt)


def qpool_attn_block(x, ln_scale, ln_bias, wskip, bskip, wqkv, bqkv, wproj,
                     bproj, heads, win, eps=1e-6, ln_width=None):
    """x (n_windows·win², C_in) window-major rows, (i, j) order inside a
    window; returns (n_windows·win²/4, C_out) in the same order. Weights
    in torch Linear layout: wskip (C_out, C_in), wqkv (3·C_out, C_in),
    wproj (C_out, C_out). CPU tensors take the plain version; CUDA
    tensors launch the one-block kernel or, where a window does not fit
    it, take the tiled route (counted in `qpool_attn_block.tiled`). Rows
    zero-padded past their true width `ln_width` (wskip's and wqkv's
    columns and the LN parameters padded with them) take the tiled route
    on both devices, as in window_attn_block."""
    if ln_width is not None:
        qpool_attn_block.tiled += x.is_cuda
        return qpool_attn_block_tiled(x, ln_scale, ln_bias, wskip, bskip, wqkv, bqkv,
                                      wproj, bproj, heads, win, eps, ln_width=ln_width)
    if x.device.type == "cpu":
        return qpool_attn_block_plain(x, ln_scale, ln_bias, wskip, bskip, wqkv,
                                      bqkv, wproj, bproj, heads, win, eps)
    check_operands("qpool_attn_block", x, wskip, bskip, wqkv, bqkv, wproj, bproj)
    check_no_grad("qpool_attn_block", x, ln_scale, ln_bias, wskip, bskip, wqkv, bqkv, wproj,
                  bproj)
    check_ln_params("qpool_attn_block", x, ln_scale, ln_bias)
    rows, c_in = x.shape
    c_out = wproj.shape[0]
    t = win * win
    if win % 2 or rows % t or wskip.shape != (c_out, c_in) \
            or wqkv.shape != (3 * c_out, c_in) or c_out % heads:
        raise KernelError("qpool_attn_block: shapes do not match an even window")
    if window_route("qpool", t, c_in, c_out, heads, x.dtype) == "tiled":
        qpool_attn_block.tiled += 1
        return qpool_attn_block_tiled(x, ln_scale, ln_bias, wskip, bskip, wqkv, bqkv,
                                      wproj, bproj, heads, win, eps)
    check_aligned("qpool_attn_block", x, wskip, wqkv, wproj)
    if x.dtype == torch.float32:  # the biases are read in pairs
        check_aligned("qpool_attn_block", bskip, bqkv, bproj, align=8)
    lib = library("window_attn")
    out = torch.empty((rows // 4, c_out), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), wskip.data_ptr(),
            bskip.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
            bproj.data_ptr(), out.data_ptr())
    if x.dtype == torch.bfloat16:
        xn = torch.empty_like(x)  # the LN pre-pass's output
        err = lib.cv_qpool_attn_bf16(*args, xn.data_ptr(), rows // t, win, c_in, c_out, heads,
                                     eps, stream_ptr(x))
    else:
        plan = qpool_plan_f32(rows, c_in, c_out, heads, sm_count(x))
        ws = torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
        err = lib.cv_qpool_attn_f32(*args, ws.data_ptr(), rows // t, win, c_in, c_out, heads,
                                    eps, plan.gemm_proj.splits, stream_ptr(x))
    check(err, "qpool_attn_block")
    qpool_attn_block.launches += 1
    return out


qpool_attn_block.launches = 0
qpool_attn_block.tiled = 0


def qpool_attn_block_tiled(x, ln_scale, ln_bias, wskip, bskip, wqkv, bqkv, wproj,
                           bproj, heads, win, eps=1e-6, ln_width=None):
    """qpool_attn_block as ln_qkv (q, k, v; then the shortcut as one
    slab) → flash_attn with q pooled as it loads → attn_proj_residual
    onto the shortcut pooled as it is read; heads padded where the dtype
    needs it (`pad_heads`; the shortcut's weight gets zero rows to the
    padded width)."""
    rows, c_in = x.shape
    t = win * win
    c_out = wproj.shape[0]
    xw = x.view(rows // t, t, c_in)
    hd, wqkv, bqkv, wproj, bproj = pad_heads(wqkv, bqkv, wproj, bproj, heads, x.dtype)
    pad = wproj.shape[0] - c_out
    if pad:
        wskip, bskip = F.pad(wskip, (0, 0, 0, pad)), F.pad(bskip, (0, pad))
    q, k, v = ln_qkv(xw, ln_scale, ln_bias, wqkv, bqkv, heads, eps=eps, ln_width=ln_width)
    skip = ln_qkv(xw, ln_scale, ln_bias, wskip, bskip, 1, slabs=1, eps=eps,
                  ln_width=ln_width)[0, :, 0]
    o = flash_attn(q, k, v, pool_win=win, scale_width=hd)
    out = attn_proj_residual(skip, o, wproj, bproj, pool_win=win, round_proj=True)
    out = out.view(rows // 4, -1)
    return out[:, :c_out].contiguous() if pad else out
