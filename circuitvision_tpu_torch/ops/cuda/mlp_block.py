"""Hiera MLP half as one kernel: out = x + W1·GELU_erf(W0·LN2(x) + b0) + b1.

Replaces the JAX package's Pallas kernel `mlp_block`
(circuitvision_tpu/ops/pallas/mlp_block.py); the CUDA source is
csrc/mlp_block.cu, whose header note says what bounds it on the H100 and
how the design answers that: bfloat16 as an LN pre-pass and two wgmma
GEMMs with h in a bf16 workspace (`mlp_plan` picks their block rows);
float32 as the same three launches with h in an f32 workspace and every
product 3×TF32 on mma.sync (csrc/tf32.cuh; `mlp_plan_f32` picks the
depth splits). `mlp_block_plain` is the same
function in plain PyTorch, with the kernel's numerics: LayerNorm
statistics in f32, products accumulated in f32, the LN output and the
hidden activation rounded to the compute dtype where the kernel stores
them.
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

#: the bf16 GEMM (csrc/mlp_block.cu gemm_tc_kernel): block rows (one
#: warpgroup per 64), block columns (one wgmma m64n128), depth of a
#: staged tile (one 128-byte swizzled row), stages of the cp.async ring
GEMM_ROWS = (128, 64)
GEMM_BN, GEMM_BK, GEMM_STAGES = 128, 64, 3
#: rows per block of the bf16 LN pre-pass (one warp each)
LN_ROWS = 8
#: SMs of an H100 SXM, for plans made without a card
H100_SMS = 132
#: the float32 GEMM (csrc/tf32.cuh gemm_kernel): a block's output tile
#: (rows, columns; a warp per 32 × 32), the depth of a staged tile (32
#: floats, a 128-byte row), stages of the cp.async ring, and the staged
#: rows' stride in floats (padded by 4, so the eight rows one ldmatrix
#: reads fall in distinct bank groups)
F32_GEMM_BM, F32_GEMM_BN = 64, 64
F32_GEMM_BK, F32_GEMM_STAGES, F32_GEMM_LD = 32, 3, 36
#: shared-memory bytes of one block: the cp.async ring of A and B tiles,
#: 144 bytes a row (csrc/tf32.cuh kGemmSmem)
F32_GEMM_SMEM = 4 * F32_GEMM_STAGES * (F32_GEMM_BM + F32_GEMM_BN) * F32_GEMM_LD
#: staged tiles one split of a GEMM's depth keeps at least
F32_MIN_SPLIT_TILES = 4


def gemm_smem(bm: int) -> int:
    """Shared-memory bytes of one GEMM block: the cp.async ring of A and B
    tiles, 128 bytes a row, plus 1024 to align it to the swizzle's pattern
    (csrc/mlp_block.cu gemm_smem)."""
    return GEMM_STAGES * (bm + GEMM_BN) * 128 + 1024


def ln_smem(c: int) -> int:
    """Shared-memory bytes of one LN pre-pass block: the rows in and out
    in float32 (csrc/mlp_block.cu ln_smem)."""
    return 4 * 2 * LN_ROWS * c


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    bm: int
    blocks: int
    smem: int


@dataclasses.dataclass(frozen=True)
class MlpPlan:
    """Launch plan of the bf16 path: h = GELU(xn·W0ᵀ + b0) (m = t, n =
    hidden, k = c), then out = x + b1 + h·W1ᵀ (m = t, n = c, k = hidden),
    with xn and h in one bf16 workspace of t·(c + hidden) elements."""

    ln_blocks: int
    ln_smem: int
    gemm1: GemmPlan
    gemm2: GemmPlan
    workspace: int


def gemm_tile(m: int, n: int, sms: int = H100_SMS) -> GemmPlan:
    """Block rows of an (m × n) output in 128-column blocks: 128 where
    that gives two blocks per SM, else 64 (one warpgroup a block, up to
    three a SM)."""
    cols = -(-n // GEMM_BN)
    bm = 128 if -(-m // 128) * cols >= 2 * sms else 64
    return GemmPlan(bm, -(-m // bm) * cols, gemm_smem(bm))


@functools.lru_cache(maxsize=64)
def mlp_plan(t: int, c: int, hidden: int, sms: int = H100_SMS) -> MlpPlan:
    if c % 8 or hidden % 8:
        raise KernelError(f"mlp_block: bfloat16 widths must be multiples of 8; got C={c}, "
                          f"hidden={hidden}")
    return MlpPlan(-(-t // LN_ROWS), ln_smem(c), gemm_tile(t, hidden, sms),
                   gemm_tile(t, c, sms), t * (c + hidden))


@dataclasses.dataclass(frozen=True)
class F32Gemm:
    """One float32 GEMM: depth splits and blocks (splits included)."""

    splits: int
    blocks: int


def f32_gemm_plan(m: int, n: int, k: int, sms: int = H100_SMS, split: bool = True) -> F32Gemm:
    """The blocks of an (m × n) output, F32_GEMM_BM × F32_GEMM_BN each.
    Where they would not fill every SM once, the depth k is split across
    blocks (`split`), enough for about two blocks per SM while each split
    keeps at least F32_MIN_SPLIT_TILES staged tiles; the kernel adds the
    partial sums in split order. The count is one the kernel's whole-tile
    split gives (csrc/tf32.cuh split_len)."""
    blocks = -(-m // F32_GEMM_BM) * -(-n // F32_GEMM_BN)
    splits = 1
    if split and blocks < sms:
        tiles = -(-k // F32_GEMM_BK)
        want = min(-(-2 * sms // blocks), max(1, tiles // F32_MIN_SPLIT_TILES))
        splits = -(-tiles // -(-tiles // want))
    return F32Gemm(splits, blocks * splits)


@dataclasses.dataclass(frozen=True)
class MlpPlanF32:
    """Launch plan of the float32 path: h = GELU(xn·W0ᵀ + b0), then out =
    x + b1 + h·W1ᵀ, with xn, h and the split GEMMs' partial sums in one
    f32 workspace of `workspace` elements, each part on a 16-byte
    boundary."""

    gemm1: F32Gemm
    gemm2: F32Gemm
    workspace: int


@functools.lru_cache(maxsize=64)
def mlp_plan_f32(t: int, c: int, hidden: int, sms: int = H100_SMS) -> MlpPlanF32:
    g1, g2 = f32_gemm_plan(t, hidden, c, sms), f32_gemm_plan(t, c, hidden, sms)
    partial = max(g1.splits * t * hidden if g1.splits > 1 else 0,
                  g2.splits * t * c if g2.splits > 1 else 0)
    return MlpPlanF32(g1, g2, -(-t * c // 4) * 4 + -(-t * hidden // 4) * 4 + partial)


def layernorm_f32(x: torch.Tensor, scale, bias, eps: float,
                  width: int | None = None) -> torch.Tensor:
    """LayerNorm with f32 fast-variance statistics (hiera.TrunkLayerNorm),
    returned in f32. `width` is the rows' true width, the statistics'
    divisor, for rows zero-padded past it (default: all of the last
    axis); zeros add nothing to the sums."""
    xf = x.float()
    c = width or x.shape[-1]
    mean = xf.sum(-1, keepdim=True) / c
    var = torch.clamp((xf * xf).sum(-1, keepdim=True) / c - mean * mean, min=0.0)
    return (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def mlp_block_plain(x, ln_scale, ln_bias, w0, b0, w1, b1, eps=1e-6, ln_width=None):
    dt = x.dtype
    xn = layernorm_f32(x, ln_scale, ln_bias, eps, ln_width).to(dt)
    h = F.gelu(xn.float() @ w0.float().t() + b0.float()).to(dt)
    return (x.float() + b1.float() + h.float() @ w1.float().t()).to(dt)


def mlp_block(x, ln_scale, ln_bias, w0, b0, w1, b1, eps=1e-6, ln_width=None):
    """x (T, C); w0 (hidden, C), w1 (C, hidden) in torch Linear layout.
    `ln_width` (bfloat16 only) is the rows' true width where x, the
    weights and the LN parameters are zero-padded past it to C, a
    multiple of 8 (hiera.pad_block): the LayerNorm divides by it. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, ln_scale, ln_bias, w0, b0, w1, b1, eps, ln_width)
    check_operands("mlp_block", x, w0, b0, w1, b1)
    check_no_grad("mlp_block", x, ln_scale, ln_bias, w0, b0, w1, b1)
    check_ln_params("mlp_block", x, ln_scale, ln_bias)
    t, c = x.shape
    hidden = w0.shape[0]
    if w0.shape != (hidden, c) or w1.shape != (c, hidden) or b0.shape != (hidden,) \
            or b1.shape != (c,):
        raise KernelError("mlp_block: weight shapes do not match x")
    if ln_width is not None and (x.dtype != torch.bfloat16 or not 0 < ln_width <= c):
        raise KernelError(f"mlp_block: a true width ({ln_width}) is taken by the bfloat16 "
                          f"kernel only, at most C={c}")
    lib = library("mlp_block")
    sms = sm_count(x)
    out = torch.empty_like(x)
    if x.dtype == torch.bfloat16:
        plan = mlp_plan(t, c, hidden, sms)
        if plan.ln_smem > MAX_SMEM:
            raise KernelError(f"mlp_block: width {c} exceeds the LN pre-pass's shared memory")
        check_aligned("mlp_block", x, w0, w1)
        ws = torch.empty(plan.workspace, dtype=torch.bfloat16, device=x.device)
        err = lib.cv_mlp_block_bf16(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w0.data_ptr(),
            b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), out.data_ptr(), ws.data_ptr(),
            ws[t * c:].data_ptr(), t, c, hidden, ln_width or c, eps, plan.gemm1.bm,
            plan.gemm2.bm,
            stream_ptr(x),
        )
    else:
        plan = mlp_plan_f32(t, c, hidden, sms)
        ws = torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
        err = lib.cv_mlp_block_f32(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w0.data_ptr(),
            b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), out.data_ptr(), ws.data_ptr(),
            t, c, hidden, eps, plan.gemm1.splits, plan.gemm2.splits, stream_ptr(x),
        )
    check(err, "mlp_block")
    mlp_block.launches += 1
    return out


mlp_block.launches = 0
