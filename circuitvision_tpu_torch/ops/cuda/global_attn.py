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
H100 and how the design answers that. The plain versions compute the
same functions with the kernels' numerics: f32 LayerNorm statistics in
the fast-variance form, products accumulated in f32 and rounded to the
compute dtype where the kernel stores them.
"""
from __future__ import annotations

import torch

from .build import (
    MAX_SMEM, KernelError, check, check_ln_params, check_operands, dtype_code, library,
    stream_ptr,
)
from .mlp_block import layernorm_f32


def pool2x2_windows(a: torch.Tensor, win: int) -> torch.Tensor:
    """2×2 max-pool of window-major rows: (..., win², C) → (..., win²/4, C)."""
    m, c = win // 2, a.shape[-1]
    return a.reshape(-1, m, 2, m, 2, c).amax(dim=(2, 4)).reshape(*a.shape[:-2], m * m, c)


def ln_qkv_plain(x, ln_scale, ln_bias, w, b, heads, slabs=3, eps=1e-6):
    dt = x.dtype
    bsz, n, _ = x.shape
    xn = layernorm_f32(x, ln_scale, ln_bias, eps).to(dt)
    y = (xn.float() @ w.float().t() + b.float()).to(dt)
    return y.view(bsz, n, slabs, heads, -1).permute(2, 0, 3, 1, 4).contiguous()


def ln_qkv(x, ln_scale, ln_bias, w, b, heads, slabs=3, eps=1e-6):
    """x (B, N, C_in); w (slabs·heads·D, C_in) in torch Linear layout.
    Returns (slabs, B, heads, N, D): q, k, v for the qkv weight, or one
    slab of one head — the plain product, row-major — for a shortcut
    projection. CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if x.device.type == "cpu":
        return ln_qkv_plain(x, ln_scale, ln_bias, w, b, heads, slabs, eps)
    check_operands("ln_qkv", x, w, b)
    check_ln_params("ln_qkv", x, ln_scale, ln_bias)
    bsz, n, c_in = x.shape
    n_out = w.shape[0]
    if n_out % (slabs * heads) or w.shape != (n_out, c_in) or b.shape != (n_out,):
        raise KernelError("ln_qkv: weight shapes do not match x")
    hd = n_out // (slabs * heads)
    lib = library("global_attn")
    if lib.cv_ln_heads_smem(c_in) > MAX_SMEM:
        raise KernelError(f"ln_qkv: width {c_in} exceeds the kernel's shared memory")
    out = torch.empty((slabs, bsz, heads, n, hd), dtype=x.dtype, device=x.device)
    err = lib.cv_ln_heads(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), bsz, n, c_in, n_out, heads, hd, eps, dtype_code(x), stream_ptr(x),
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
    version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return attn_proj_residual_plain(x, o, wproj, bproj, pool_win, round_proj)
    check_operands("attn_proj_residual", x, o, wproj, bproj)
    bsz, heads, n, hd = o.shape
    c = heads * hd
    rows = pool_win * pool_win if pool_win else n
    if x.shape != (bsz, rows, c) or wproj.shape != (c, c) or bproj.shape != (c,) \
            or (pool_win and (pool_win % 2 or 4 * n != rows)):
        raise KernelError("attn_proj_residual: shapes of x, o and the weight do not match")
    lib = library("global_attn")
    if lib.cv_proj_res_smem(c) > MAX_SMEM:
        raise KernelError(f"attn_proj_residual: width {c} exceeds the kernel's shared memory")
    out = torch.empty((bsz, n, c), dtype=x.dtype, device=x.device)
    err = lib.cv_proj_res(
        x.data_ptr(), o.data_ptr(), wproj.data_ptr(), bproj.data_ptr(), out.data_ptr(),
        bsz, n, heads, hd, pool_win, int(round_proj), dtype_code(x), stream_ptr(x),
    )
    check(err, "attn_proj_residual")
    attn_proj_residual.launches += 1
    return out


attn_proj_residual.launches = 0
