"""SAM2 MultiKernelRefinement head as one kernel.

Replaces the JAX package's Pallas kernel `refinement_fused`
(circuitvision_tpu/ops/pallas/refinement_fused.py): four parallel 1→4
channel convolutions with k = 3, 5, 7 and 11 (SAME zero padding), exact
GELU, and a 1×1 combiner from 16 channels to 1, over the
full-resolution logit map. The CUDA source is csrc/refinement.cu, whose
header note says what bounds it on the H100 and how the design answers
that. `refinement_plain` is the same function in plain PyTorch, in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .build import (
    KernelError, check, check_no_grad, check_operands, dtype_code, library, stream_ptr,
)

KERNELS = (3, 5, 7, 11)


def refinement_plain(logits, branch_weights, branch_biases, comb_weight, comb_bias):
    """logits (B, H, W, 1) → refined (B, H, W, 1) float32."""
    x = logits.float().permute(0, 3, 1, 2)
    branches = [
        F.gelu(F.conv2d(x, w.float(), b.float(), padding=w.shape[-1] // 2))
        for w, b in zip(branch_weights, branch_biases)
    ]
    y = F.conv2d(torch.cat(branches, dim=1), comb_weight.float(), comb_bias.float())
    return y.permute(0, 2, 3, 1)


def refinement(logits, branch_weights, branch_biases, comb_weight, comb_bias):
    """logits (B, H, W, 1); branch weights in torch Conv2d layout
    (4, 1, k, k) for k = 3, 5, 7, 11, biases (4,), combiner (1, 16, 1, 1)
    and (1,). Returns (B, H, W, 1) float32. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if logits.device.type == "cpu":
        return refinement_plain(logits, branch_weights, branch_biases, comb_weight, comb_bias)
    params = [p for wb in zip(branch_weights, branch_biases) for p in wb]
    check_operands("refinement", logits, *params, comb_weight, comb_bias)
    check_no_grad("refinement", logits, *params, comb_weight, comb_bias)
    b, h, w, one = logits.shape
    shapes_ok = one == 1 and comb_weight.shape == (1, 16, 1, 1) and all(
        wt.shape == (4, 1, k, k) and bs.shape == (4,)
        for wt, bs, k in zip(branch_weights, branch_biases, KERNELS)
    )
    if not shapes_ok or len(branch_weights) != len(KERNELS):
        raise KernelError("refinement: weights are not the (3, 5, 7, 11) × 4 head")
    out = torch.empty((b, h, w, 1), dtype=torch.float32, device=logits.device)
    err = library("refinement").cv_refinement(
        logits.data_ptr(), *(p.data_ptr() for p in params), comb_weight.data_ptr(),
        comb_bias.data_ptr(), out.data_ptr(), b, h, w, dtype_code(logits),
        stream_ptr(logits),
    )
    check(err, "refinement")
    refinement.launches += 1
    return out


refinement.launches = 0
