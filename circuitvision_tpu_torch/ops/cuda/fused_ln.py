"""Row-wise LayerNorm of the Hiera trunk as kernels: `fused_layernorm`
y = LN(x), and `fused_add_layernorm` (a + b, LN(a + b)) in one pass.

Replaces the JAX package's Pallas kernels of the same names
(circuitvision_tpu/ops/pallas/fused_ln.py); the CUDA source is
csrc/fused_ln.cu, whose header note says what bounds them on the H100
and how the design answers that. The plain versions beside them compute
the same functions with the kernels' numerics: f32 statistics in the
fast-variance form, the affine in f32 with float32 scale and bias, the
output rounded to the input dtype, and the residual sum rounded to the
input dtype before its statistics are taken. The statistics divide by
C: the port has no channel padding, so the Pallas kernels' `true_dim`
has no counterpart.
"""
from __future__ import annotations

import torch

from .build import KernelError, check, check_ln_params, check_no_grad, check_operands, dtype_code, \
    library, stream_ptr
from .mlp_block import layernorm_f32


def fused_layernorm_plain(x, scale, bias, eps=1e-6):
    return layernorm_f32(x, scale, bias, eps).to(x.dtype)


def fused_add_layernorm_plain(a, b, scale, bias, eps=1e-6):
    resid = a + b
    return resid, layernorm_f32(resid, scale, bias, eps).to(a.dtype)


def _check_rows(what, x, scale, bias):
    if x.dim() != 2:
        raise KernelError(f"{what}: needs (T, C) rows; got {tuple(x.shape)}")
    check_ln_params(what, x, scale, bias)


def fused_layernorm(x, scale, bias, eps=1e-6):
    """x (T, C) float32 or bfloat16; scale, bias (C,) float32. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return fused_layernorm_plain(x, scale, bias, eps)
    check_operands("fused_layernorm", x)
    check_no_grad("fused_layernorm", x, scale, bias)
    _check_rows("fused_layernorm", x, scale, bias)
    t, c = x.shape
    out = torch.empty_like(x)
    err = library("fused_ln").cv_fused_layernorm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), t, c, eps,
        dtype_code(x), stream_ptr(x))
    check(err, "fused_layernorm")
    fused_layernorm.launches += 1
    return out


def fused_add_layernorm(a, b, scale, bias, eps=1e-6):
    """(a + b, LN(a + b)) for a, b (T, C) of one dtype; scale, bias (C,)
    float32. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if a.device.type == "cpu":
        return fused_add_layernorm_plain(a, b, scale, bias, eps)
    check_operands("fused_add_layernorm", a, b)
    check_no_grad("fused_add_layernorm", a, b, scale, bias)
    _check_rows("fused_add_layernorm", a, scale, bias)
    if b.shape != a.shape:
        raise KernelError(f"fused_add_layernorm: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    t, c = a.shape
    resid, out = torch.empty_like(a), torch.empty_like(a)
    err = library("fused_ln").cv_fused_add_layernorm(
        a.data_ptr(), b.data_ptr(), scale.data_ptr(), bias.data_ptr(), resid.data_ptr(),
        out.data_ptr(), t, c, eps, dtype_code(a), stream_ptr(a))
    check(err, "fused_add_layernorm")
    fused_add_layernorm.launches += 1
    return resid, out


fused_layernorm.launches = 0
fused_add_layernorm.launches = 0
