"""The shell around attention in the Hiera global blocks, as two kernels.

Replaces two Pallas kernels of the JAX package
(circuitvision_tpu/ops/pallas/global_attn.py):

  * `ln_qkv` for `ln_qkv_flash`: LN1(x)·Wᵀ + b split into head-major
    slabs, q, k, v each (B, H, N, D) — without the 72 → 128 lane pad,
    which only served the TPU's matrix unit;
  * `attn_proj_residual`: x + concat_heads(o)·Wprojᵀ + b, reading the
    attention output o head-major.

The large-window routes of the window and q-pool blocks
(ops/cuda/window_attn.py) use them too, with one slab for the q-pool
shortcut and the residual 2×2-pooled as it is read. The CUDA source is
csrc/global_attn.cu; its header note says what bounds the kernels on the
H100 and how the design answers that. In bfloat16 both run on the tensor
cores, through the wgmma GEMM that `mlp_block` uses (csrc/tc_gemm.cuh):
`ln_qkv` as an LN pre-pass into a bf16 workspace and the GEMM with the
head split in its epilogue's store address (`ln_qkv_plan`);
`attn_proj_residual` as one GEMM whose A operand, concat_heads(o), is
read where it lies, head by head, and whose epilogue adds the bias and
the residual, pooled where asked (`proj_res_plan`). In float32, f32 FMA
loops. The plain versions compute the same functions with the kernels'
numerics: f32 LayerNorm statistics in the fast-variance form, products
accumulated in f32 and rounded to the compute dtype where the kernel
stores them.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from .build import (
    MAX_SMEM, KernelError, check, check_aligned, check_ln_params, check_no_grad, check_operands,
    library, sm_count, stream_ptr,
)
from .mlp_block import H100_SMS, LN_ROWS, GemmPlan, gemm_tile, layernorm_f32, ln_smem


@dataclasses.dataclass(frozen=True)
class LnQkvPlan:
    """Launch plan of the bf16 `ln_qkv`: the LN pre-pass over m rows of
    width k into a bf16 workspace of m·k elements, then the GEMM of its
    (m × n) output, n = slabs·heads·hd."""

    ln_blocks: int
    ln_smem: int
    gemm: GemmPlan
    workspace: int


@functools.lru_cache(maxsize=64)
def ln_qkv_plan(m: int, k: int, n: int, sms: int = H100_SMS) -> LnQkvPlan:
    """The pre-pass of mlp_block's bf16 path and its GEMM's block rows
    (ops/cuda/mlp_block.py gemm_tile). The GEMM copies rows of k in
    16-byte pieces, so k must be a multiple of 8."""
    if k % 8 or n % 2:
        raise KernelError(f"ln_qkv: bfloat16 widths must be multiples of 8 in and 2 out; got "
                          f"C_in={k}, N={n}")
    return LnQkvPlan(-(-m // LN_ROWS), ln_smem(k), gemm_tile(m, n, sms), m * k)


#: head widths the bf16 attn_proj_residual has an A-layout instance for
#: (a template argument: the division by the head width is a multiply),
#: those of Hiera-b+, -L and -t/-s; any other multiple of 8 takes the
#: layout whose width is a runtime value
PROJ_HEAD_WIDTHS = (56, 72, 96)


@functools.lru_cache(maxsize=64)
def proj_res_plan(m: int, c: int, sms: int = H100_SMS) -> GemmPlan:
    """Block rows of the bf16 `attn_proj_residual` GEMM over its (m × c)
    output at depth c (ops/cuda/mlp_block.py gemm_tile). The GEMM copies
    rows of c in 16-byte pieces, so c must be a multiple of 8; the head
    width's own rule is `proj_a_width`'s."""
    if c % 8:
        raise KernelError(f"attn_proj_residual: bfloat16 width {c} is not a multiple of 8")
    return gemm_tile(m, c, sms)


def proj_a_width(hd: int) -> int:
    """The A layout of the bf16 `attn_proj_residual` at head width hd:
    hd itself where PROJ_HEAD_WIDTHS has an instance for it, else 0, the
    layout whose head width is a runtime value. Both copy the heads in
    16-byte pieces, which never straddle two heads when hd is a multiple
    of 8; other widths are refused."""
    if hd < 8 or hd % 8:
        raise KernelError(f"attn_proj_residual: bfloat16 head width {hd} is not a multiple "
                          f"of 8")
    return hd if hd in PROJ_HEAD_WIDTHS else 0


def pool2x2_windows(a: torch.Tensor, win: int) -> torch.Tensor:
    """2×2 max-pool of window-major rows: (..., win², C) → (..., win²/4, C)."""
    m, c = win // 2, a.shape[-1]
    return a.reshape(-1, m, 2, m, 2, c).amax(dim=(2, 4)).reshape(*a.shape[:-2], m * m, c)


def ln_qkv_plain(x, ln_scale, ln_bias, w, b, heads, slabs=3, eps=1e-6, ln_width=None):
    dt = x.dtype
    bsz, n, _ = x.shape
    xn = layernorm_f32(x, ln_scale, ln_bias, eps, ln_width).to(dt)
    y = (xn.float() @ w.float().t() + b.float()).to(dt)
    return y.view(bsz, n, slabs, heads, -1).permute(2, 0, 3, 1, 4).contiguous()


def ln_qkv(x, ln_scale, ln_bias, w, b, heads, slabs=3, eps=1e-6, ln_width=None):
    """x (B, N, C_in); w (slabs·heads·D, C_in) in torch Linear layout.
    Returns (slabs, B, heads, N, D): q, k, v for the qkv weight, or one
    slab of one head — the plain product, row-major — for a shortcut
    projection. `ln_width` (bfloat16 only) is the rows' true width where
    x, w's columns and the LN parameters are zero-padded past it: the
    LayerNorm divides by it. CPU tensors take the plain version; CUDA
    tensors launch the kernel (bfloat16: C_in a multiple of 8, an even
    head width)."""
    if x.device.type == "cpu":
        return ln_qkv_plain(x, ln_scale, ln_bias, w, b, heads, slabs, eps, ln_width)
    check_operands("ln_qkv", x, w, b)
    check_no_grad("ln_qkv", x, ln_scale, ln_bias, w, b)
    check_ln_params("ln_qkv", x, ln_scale, ln_bias)
    bsz, n, c_in = x.shape
    n_out = w.shape[0]
    if n_out % (slabs * heads) or w.shape != (n_out, c_in) or b.shape != (n_out,):
        raise KernelError("ln_qkv: weight shapes do not match x")
    hd = n_out // (slabs * heads)
    if ln_width is not None and (x.dtype != torch.bfloat16 or not 0 < ln_width <= c_in):
        raise KernelError(f"ln_qkv: a true width ({ln_width}) is taken by the bfloat16 kernel "
                          f"only, at most C_in={c_in}")
    lib = library("global_attn")
    out = torch.empty((slabs, bsz, heads, n, hd), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        if hd % 2:
            raise KernelError(f"ln_qkv: bfloat16 head width {hd} is odd")
        plan = ln_qkv_plan(bsz * n, c_in, n_out, sm_count(x))
        if plan.ln_smem > MAX_SMEM:
            raise KernelError(f"ln_qkv: width {c_in} exceeds the LN pre-pass's shared memory")
        check_aligned("ln_qkv", x, w)
        xn = torch.empty(plan.workspace, dtype=torch.bfloat16, device=x.device)
        err = lib.cv_ln_heads_bf16(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), xn.data_ptr(), bsz, n, c_in, n_out, heads, hd, ln_width or c_in,
            eps, plan.gemm.bm,
            stream_ptr(x),
        )
    else:
        if lib.cv_ln_heads_smem(c_in) > MAX_SMEM:
            raise KernelError(f"ln_qkv: width {c_in} exceeds the kernel's shared memory")
        err = lib.cv_ln_heads_f32(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), bsz, n, c_in, n_out, heads, hd, eps, stream_ptr(x),
        )
    check(err, "ln_qkv")
    ln_qkv.launches += 1
    return out


ln_qkv.launches = 0


def attn_proj_residual_plain(x, o, wproj, bproj, pool_win=0, round_proj=False):
    dt = x.dtype
    bsz, heads, n, hd = o.shape
    a = o.permute(0, 2, 1, 3).reshape(bsz, n, heads * hd)
    proj = a.float() @ wproj.float().t() + bproj.float()
    if round_proj:
        proj = proj.to(dt).float()
    res = pool2x2_windows(x, pool_win) if pool_win else x
    return (res.float() + proj).to(dt)


def attn_proj_residual(x, o, wproj, bproj, pool_win=0, round_proj=False):
    """o (B, H, N, D) head-major; wproj (C, C) in torch Linear layout,
    C = H·D. Returns x + concat_heads(o)·wprojᵀ + bproj, (B, N, C). With
    `pool_win` the residual is the 2×2 max-pool of x, window-major rows
    (B, pool_win², C) with N = pool_win²/4. `round_proj` rounds the
    projection to x's dtype before the add, as the window kernels do; the
    global blocks round once, at the end. CPU tensors take the plain
    version; CUDA tensors launch the kernel (bfloat16: a head width that
    is a multiple of 8, operands on 16-byte boundaries)."""
    if x.device.type == "cpu":
        return attn_proj_residual_plain(x, o, wproj, bproj, pool_win, round_proj)
    check_operands("attn_proj_residual", x, o, wproj, bproj)
    check_no_grad("attn_proj_residual", x, o, wproj, bproj)
    bsz, heads, n, hd = o.shape
    c = heads * hd
    rows = pool_win * pool_win if pool_win else n
    if x.shape != (bsz, rows, c) or wproj.shape != (c, c) or bproj.shape != (c,) \
            or (pool_win and (pool_win % 2 or 4 * n != rows)):
        raise KernelError("attn_proj_residual: shapes of x, o and the weight do not match")
    lib = library("global_attn")
    out = torch.empty((bsz, n, c), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        a_width = proj_a_width(hd)
        plan = proj_res_plan(bsz * n, c, sm_count(x))
        check_aligned("attn_proj_residual", x, o, wproj)
        err = lib.cv_proj_res_bf16(
            x.data_ptr(), o.data_ptr(), wproj.data_ptr(), bproj.data_ptr(), out.data_ptr(),
            bsz, n, heads, hd, pool_win, int(round_proj), a_width, plan.bm, stream_ptr(x),
        )
    else:
        if lib.cv_proj_res_smem(c) > MAX_SMEM:
            raise KernelError(f"attn_proj_residual: width {c} exceeds the kernel's shared memory")
        err = lib.cv_proj_res_f32(
            x.data_ptr(), o.data_ptr(), wproj.data_ptr(), bproj.data_ptr(), out.data_ptr(),
            bsz, n, heads, hd, pool_win, int(round_proj), stream_ptr(x),
        )
    check(err, "attn_proj_residual")
    attn_proj_residual.launches += 1
    return out


attn_proj_residual.launches = 0
