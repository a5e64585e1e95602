"""Non-causal softmax attention as one kernel with online softmax.

Replaces jax's TPU flash attention
(jax.experimental.pallas.ops.tpu.flash_attention), which the JAX package
calls for the Hiera global blocks (circuitvision_tpu/models/sam2/
hiera.py:487); the large-window routes of the window and q-pool blocks
(ops/cuda/window_attn.py) use it too, the q-pool route with q 2×2-pooled
as the kernel loads it. The CUDA source is csrc/flash_attn.cu; its header
note says what bounds it on the H100 and how the design answers that.

`flash_attn_plain` is the JAX package's einsum attention, the reference
its flash path is held to: f32 scores scaled by D^-0.5 from the true
head width, f32 softmax, probabilities rounded to the compute dtype, p·v
accumulated in f32 and rounded. The kernel rounds the probabilities
before normalising them (as jax's kernel does), so in bfloat16 the two
differ by that rounding; in float32 only the order of the sums differs.
"""
from __future__ import annotations

import torch

from .build import KernelError, check, check_operands, dtype_code, library, stream_ptr
from .global_attn import pool2x2_windows

#: largest head width the kernel takes (csrc/flash_attn.cu kMaxD)
MAX_HEAD_DIM = 128
#: score elements the plain version holds at once (64 MiB in f32)
_PLAIN_CHUNK = 1 << 24


def flash_attn_plain(q, k, v, pool_win=0):
    dt = q.dtype
    if pool_win:
        q = pool2x2_windows(q, pool_win)
    b, h, nq, hd = q.shape
    kf, vf = k.float(), v.float()
    out = torch.empty((b, h, nq, hd), dtype=dt, device=q.device)
    step = max(1, _PLAIN_CHUNK // (b * h * k.shape[2]))
    for i in range(0, nq, step):
        s = (q[:, :, i:i + step].float() @ kf.transpose(-1, -2)) * hd ** -0.5
        p = torch.softmax(s, dim=-1).to(dt)
        out[:, :, i:i + step] = (p.float() @ vf).to(dt)
    return out


def flash_attn(q, k, v, pool_win=0):
    """q (B, H, Nq, D), k and v (B, H, Nk, D) → (B, H, Nq, D), softmax
    scale D^-0.5. With `pool_win`, q is (B, H, pool_win², D) window-major
    and is 2×2 max-pooled to Nq = pool_win²/4 rows. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_attn_plain(q, k, v, pool_win)
    check_operands("flash_attn", q, k, v)
    b, h, nq_in, hd = q.shape
    nk = k.shape[2]
    if k.shape != (b, h, nk, hd) or v.shape != k.shape or hd > MAX_HEAD_DIM or nk < 1 \
            or (pool_win and (pool_win % 2 or nq_in != pool_win * pool_win)):
        raise KernelError(f"flash_attn: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                          f"v {tuple(v.shape)}, pool_win {pool_win} do not fit")
    nq = nq_in // 4 if pool_win else nq_in
    out = torch.empty((b, h, nq, hd), dtype=q.dtype, device=q.device)
    err = library("flash_attn").cv_flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, nq, nk, hd,
        pool_win, dtype_code(q), stream_ptr(q),
    )
    check(err, "flash_attn")
    flash_attn.launches += 1
    return out


flash_attn.launches = 0
