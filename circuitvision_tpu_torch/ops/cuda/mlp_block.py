"""Hiera MLP half as one kernel: out = x + W1·GELU_erf(W0·LN2(x) + b0) + b1.

Replaces the JAX package's Pallas kernel `mlp_block`
(circuitvision_tpu/ops/pallas/mlp_block.py); the CUDA source is
csrc/mlp_block.cu, whose header note says what bounds it on the H100 and
how the design answers that. `mlp_block_plain` is the same function in
plain PyTorch, with the kernel's numerics: LayerNorm statistics in f32,
products accumulated in f32, the LN output and the hidden activation
rounded to the compute dtype where the kernel stores them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .build import (
    MAX_SMEM, KernelError, check, check_ln_params, check_operands, dtype_code, library,
    stream_ptr,
)


def layernorm_f32(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """LayerNorm with f32 fast-variance statistics (hiera.TrunkLayerNorm),
    returned in f32."""
    xf = x.float()
    c = x.shape[-1]
    mean = xf.sum(-1, keepdim=True) / c
    var = torch.clamp((xf * xf).sum(-1, keepdim=True) / c - mean * mean, min=0.0)
    return (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def mlp_block_plain(x, ln_scale, ln_bias, w0, b0, w1, b1, eps=1e-6):
    dt = x.dtype
    xn = layernorm_f32(x, ln_scale, ln_bias, eps).to(dt)
    h = F.gelu(xn.float() @ w0.float().t() + b0.float()).to(dt)
    return (x.float() + b1.float() + h.float() @ w1.float().t()).to(dt)


def mlp_block(x, ln_scale, ln_bias, w0, b0, w1, b1, eps=1e-6):
    """x (T, C); w0 (hidden, C), w1 (C, hidden) in torch Linear layout.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, ln_scale, ln_bias, w0, b0, w1, b1, eps)
    check_operands("mlp_block", x, w0, b0, w1, b1)
    check_ln_params("mlp_block", x, ln_scale, ln_bias)
    t, c = x.shape
    hidden = w0.shape[0]
    if w0.shape != (hidden, c) or w1.shape != (c, hidden) or b0.shape != (hidden,) \
            or b1.shape != (c,):
        raise KernelError("mlp_block: weight shapes do not match x")
    lib = library("mlp_block")
    if lib.cv_mlp_block_smem(c) > MAX_SMEM:
        raise KernelError(f"mlp_block: width {c} exceeds the kernel's shared memory")
    # row tiles alone leave most SMs idle at small T: the launcher says
    # how many blocks share each tile's hidden dimension
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = lib.cv_mlp_block_splits(t, hidden, sms)
    out = torch.empty_like(x)
    partial = (torch.empty((splits, t, c), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    err = lib.cv_mlp_block(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w0.data_ptr(),
        b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        t, c, hidden, splits, eps, dtype_code(x), stream_ptr(x),
    )
    check(err, "mlp_block")
    mlp_block.launches += 1
    return out


mlp_block.launches = 0
