"""Hiera windowed-attention halves as kernels, one block per window.

Replaces two Pallas kernels of the JAX package
(circuitvision_tpu/ops/pallas/window_attn.py):

  * `window_attn_block`: out = x + proj(softmax(q·kᵀ·s)·v) with
    qkv = W·LN1(x), over (n_windows, T, C) windows;
  * `qpool_attn_block`: the stage-transition block — xn = LN1(x),
    skip = maxpool2×2(xn·Wskip + b), q = maxpool2×2(q(xn)), k and v from
    xn, out = skip + proj(attention) — over window-major rows, emitting
    win²/4 rows per window.

The CUDA source is csrc/window_attn.cu; its header note says what bounds
the kernels on the H100 and how the design answers that. The plain
versions beside them compute the same functions with the kernels'
numerics: f32 LayerNorm statistics, f32 scores and softmax scaled by
1/sqrt(head width), products accumulated in f32, and values rounded to
the compute dtype where the kernel stores them.
"""
from __future__ import annotations

import torch

from .build import (
    MAX_SMEM, KernelError, check, check_operands, dtype_code, library, stream_ptr,
)
from .mlp_block import layernorm_f32


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dt) -> torch.Tensor:
    """x·wᵀ + b accumulated in f32, rounded to dt."""
    return (x.float() @ w.float().t() + b.float()).to(dt)


def _attention(q, k, v, scale: float, dt) -> torch.Tensor:
    """(B, Nq, H, D) × (B, Nk, H, D) softmax attention: f32 scores and
    softmax, probabilities in dt, p·v in f32 rounded to dt."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(dt)


def _pool2x2(a: torch.Tensor, n_win: int, win: int) -> torch.Tensor:
    """2×2 max-pool of window-major rows (n_win·win², C) → (n_win·win²/4, C)."""
    m, c = win // 2, a.shape[-1]
    return a.view(n_win, m, 2, m, 2, c).amax(dim=(2, 4)).reshape(-1, c)


def window_attn_block_plain(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                            heads, eps=1e-6):
    dt = x.dtype
    nw, t, c = x.shape
    xn = layernorm_f32(x, ln_scale, ln_bias, eps).to(dt)
    qkv = _linear(xn, wqkv, bqkv, dt).view(nw, t, 3, heads, c // heads)
    o = _attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], (c // heads) ** -0.5, dt)
    return x + _linear(o.reshape(nw, t, c), wproj, bproj, dt)


def window_attn_block(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                      heads, eps=1e-6):
    """x (n_windows, T, C); wqkv (3C, C), wproj (C, C) in torch Linear
    layout. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if x.device.type == "cpu":
        return window_attn_block_plain(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                                       bproj, heads, eps)
    check_operands("window_attn_block", x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj)
    nw, t, c = x.shape
    if wqkv.shape != (3 * c, c) or wproj.shape != (c, c) or c % heads:
        raise KernelError("window_attn_block: weight shapes do not match x")
    lib = library("window_attn")
    if lib.cv_window_attn_smem(t, c) > MAX_SMEM:
        raise KernelError(f"window_attn_block: a {t}-token window of width {c} "
                          "exceeds the kernel's shared memory")
    out = torch.empty_like(x)
    err = lib.cv_window_attn(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), wqkv.data_ptr(),
        bqkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(), out.data_ptr(),
        nw, t, c, heads, eps, dtype_code(x), stream_ptr(x),
    )
    check(err, "window_attn_block")
    window_attn_block.launches += 1
    return out


window_attn_block.launches = 0


def qpool_attn_block_plain(x, ln_scale, ln_bias, wskip, bskip, wqkv, bqkv,
                           wproj, bproj, heads, win, eps=1e-6):
    dt = x.dtype
    t = win * win
    nw, c_out = x.shape[0] // t, wproj.shape[0]
    hd = c_out // heads
    xn = layernorm_f32(x, ln_scale, ln_bias, eps).to(dt)
    skip = _pool2x2(_linear(xn, wskip, bskip, dt), nw, win)
    qkv = _linear(xn, wqkv, bqkv, dt)
    q = _pool2x2(qkv[:, :c_out], nw, win).view(nw, t // 4, heads, hd)
    k = qkv[:, c_out : 2 * c_out].reshape(nw, t, heads, hd)
    v = qkv[:, 2 * c_out :].reshape(nw, t, heads, hd)
    o = _attention(q, k, v, hd ** -0.5, dt).reshape(nw * t // 4, c_out)
    return skip + _linear(o, wproj, bproj, dt)


def qpool_attn_block(x, ln_scale, ln_bias, wskip, bskip, wqkv, bqkv, wproj,
                     bproj, heads, win, eps=1e-6):
    """x (n_windows·win², C_in) window-major rows, (i, j) order inside a
    window; returns (n_windows·win²/4, C_out) in the same order. Weights
    in torch Linear layout: wskip (C_out, C_in), wqkv (3·C_out, C_in),
    wproj (C_out, C_out). CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if x.device.type == "cpu":
        return qpool_attn_block_plain(x, ln_scale, ln_bias, wskip, bskip, wqkv,
                                      bqkv, wproj, bproj, heads, win, eps)
    check_operands("qpool_attn_block", x, ln_scale, ln_bias, wskip, bskip, wqkv,
                   bqkv, wproj, bproj)
    rows, c_in = x.shape
    c_out = wproj.shape[0]
    t = win * win
    if win % 2 or rows % t or wskip.shape != (c_out, c_in) \
            or wqkv.shape != (3 * c_out, c_in) or c_out % heads:
        raise KernelError("qpool_attn_block: shapes do not match an even window")
    lib = library("window_attn")
    if lib.cv_qpool_attn_smem(win, c_in, c_out) > MAX_SMEM:
        raise KernelError(f"qpool_attn_block: a {win}×{win} window of widths "
                          f"{c_in}→{c_out} exceeds the kernel's shared memory")
    out = torch.empty((rows // 4, c_out), dtype=x.dtype, device=x.device)
    err = lib.cv_qpool_attn(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), wskip.data_ptr(),
        bskip.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
        bproj.data_ptr(), out.data_ptr(), rows // t, win, c_in, c_out, heads,
        eps, dtype_code(x), stream_ptr(x),
    )
    check(err, "qpool_attn_block")
    qpool_attn_block.launches += 1
    return out


qpool_attn_block.launches = 0
