"""Non-causal softmax attention as one kernel with online softmax.

Replaces jax's TPU flash attention
(jax.experimental.pallas.ops.tpu.flash_attention), which the JAX package
calls for the Hiera global blocks (circuitvision_tpu/models/sam2/
hiera.py:487); the large-window routes of the window and q-pool blocks
(ops/cuda/window_attn.py) use it too, the q-pool route with q 2×2-pooled
as the kernel loads it. The CUDA source is csrc/flash_attn.cu; its header
note says what bounds it on the H100 and how the design answers that.

`flash_attn_plain` is the JAX package's einsum attention, the reference
its flash path is held to: f32 scores scaled by the true head width's
^-0.5 (`scale_width`, D unless the heads were padded), f32 softmax,
probabilities rounded to the compute dtype, p·v accumulated in f32 and
rounded. The kernel rounds the probabilities
before normalising them (as jax's kernel does), so in bfloat16 the two
differ by that rounding; in float32 only the order of the sums differs.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from .build import (
    MAX_SMEM, KernelError, check, check_aligned, check_operands, library, sm_count, stream_ptr,
)
from .global_attn import pool2x2_windows

#: largest head width of the float32 kernel (csrc/flash_attn.cu kMaxD),
#: and of the Hiera global blocks' kernel path (as in the JAX trunk)
MAX_HEAD_DIM = 128
#: log2(e): the bf16 kernel's softmax runs in base 2
_LOG2E = 1.4426950408889634
#: score elements the plain version holds at once (64 MiB in f32)
_PLAIN_CHUNK = 1 << 24
#: the bfloat16 kernel's shape (csrc/flash_attn.cu): head widths it is
#: built for (a head takes the narrowest that holds it, the extra columns
#: zero; 136 and 256 serve heads wider than 128), warps per block, q rows
#: per m16 tile, keys per streamed K/V tile, and the widest head whose
#: warps may hold two q tiles
TC_WIDTHS = (32, 64, 72, 96, 128, 136, 256)
TC_WARPS, TC_Q_ROWS, TC_KEYS = 4, 16, 64
TC_MAX_WIDE_WIDTH = 72
#: SMs of an H100 SXM, for plans made without a card
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """Launch plan of the bfloat16 kernel for one call."""

    width: int   # the instance's head width, ≥ hd
    mt: int      # m16 q tiles per warp: 2 for long sequences, else 1
    wpp: int     # warps per (batch·head, q tile) problem: 1, 2 or 4
    stages: int  # K/V buffers per problem: 2, or 1 where one tile holds every key
    blocks: int
    smem: int    # shared-memory bytes per block


def tc_depth(width: int) -> int:
    """Depth of q·kᵀ at an instance's head width: padded with zero
    columns to a multiple of mma's k = 16."""
    return -(-width // 16) * 16


def flash_tc_smem(width: int, mt: int, wpp: int, stages: int) -> int:
    """Shared-memory bytes of a bfloat16 block (csrc/flash_attn.cu
    flash_tc_smem): the 4 warps' q tiles, then each group's K and V
    buffers, rows of the padded depth plus 8 bf16."""
    ld = tc_depth(width) + 8
    return 2 * ld * (TC_WARPS * TC_Q_ROWS * mt + (TC_WARPS // wpp) * stages * 2 * TC_KEYS)


@functools.lru_cache(maxsize=256)
def flash_plan(bh: int, nq: int, nk: int, hd: int, sms: int = H100_SMS) -> FlashPlan:
    """The bfloat16 launch for bh = batch·heads problems of nq queries and
    nk keys at head width hd: one warp per problem where nq ≤ 16 (four
    problems a block), two where nq ≤ 32, else q tiles of four warps —
    128 rows (two m16 tiles a warp, each K/V tile read once for twice the
    rows) where nq > 64 and that still gives `sms` blocks, 64 otherwise;
    more warps per problem where the groups' K/V buffers would not fit
    shared memory."""
    if hd < 8 or hd % 8 or hd > TC_WIDTHS[-1]:
        raise KernelError(f"flash_attn: bfloat16 head width {hd} is not a multiple of 8 "
                          f"up to {TC_WIDTHS[-1]}")
    width = next(w for w in TC_WIDTHS if w >= hd)
    stages = 1 if nk <= TC_KEYS else 2
    wpp = 1 if nq <= TC_Q_ROWS else 2 if nq <= 2 * TC_Q_ROWS else TC_WARPS
    while wpp < TC_WARPS and flash_tc_smem(width, 1, wpp, stages) > MAX_SMEM:
        wpp *= 2

    def blocks(mt):
        tiles = bh * -(-nq // (TC_Q_ROWS * mt * wpp))
        return -(-tiles // (TC_WARPS // wpp))

    wide = nq > TC_WARPS * TC_Q_ROWS and width <= TC_MAX_WIDE_WIDTH and blocks(2) >= sms
    mt = 2 if wide else 1
    return FlashPlan(width, mt, wpp, stages, blocks(mt), flash_tc_smem(width, mt, wpp, stages))


def flash_attn_plain(q, k, v, pool_win=0, scale_width=None):
    dt = q.dtype
    if pool_win:
        q = pool2x2_windows(q, pool_win)
    b, h, nq, hd = q.shape
    scale = (scale_width or hd) ** -0.5
    kf, vf = k.float(), v.float()
    out = torch.empty((b, h, nq, hd), dtype=dt, device=q.device)
    step = max(1, _PLAIN_CHUNK // (b * h * k.shape[2]))
    for i in range(0, nq, step):
        s = (q[:, :, i:i + step].float() @ kf.transpose(-1, -2)) * scale
        p = torch.softmax(s, dim=-1).to(dt)
        out[:, :, i:i + step] = (p.float() @ vf).to(dt)
    return out


def flash_attn(q, k, v, pool_win=0, scale_width=None):
    """q (B, H, Nq, D), k and v (B, H, Nk, D) → (B, H, Nq, D), softmax
    scale scale_width^-0.5 (default D; the padded heads of the bf16 tiled
    route give their true width, their extra columns being zero). With
    `pool_win`, q is (B, H, pool_win², D) window-major and is 2×2
    max-pooled to Nq = pool_win²/4 rows. CPU tensors take the plain
    version; CUDA tensors launch the kernel: bfloat16 on the tensor cores
    (D a multiple of 8 up to 256), float32 on the FMA units (D ≤ 128)."""
    if q.device.type == "cpu":
        return flash_attn_plain(q, k, v, pool_win, scale_width)
    check_operands("flash_attn", q, k, v)
    b, h, nq_in, hd = q.shape
    nk = k.shape[2]
    widest = TC_WIDTHS[-1] if q.dtype == torch.bfloat16 else MAX_HEAD_DIM
    if k.shape != (b, h, nk, hd) or v.shape != k.shape or hd > widest or nk < 1 \
            or (pool_win and (pool_win % 2 or nq_in != pool_win * pool_win)):
        raise KernelError(f"flash_attn: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                          f"v {tuple(v.shape)}, pool_win {pool_win} do not fit")
    nq = nq_in // 4 if pool_win else nq_in
    out = torch.empty((b, h, nq, hd), dtype=q.dtype, device=q.device)
    lib = library("flash_attn")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if q.dtype == torch.bfloat16:
        sms = sm_count(q)
        plan = flash_plan(b * h, nq, nk, hd, sms)
        check_aligned("flash_attn", q, k, v, out)
        err = lib.cv_flash_attn_bf16(*ptrs, b * h, nq, nk, hd, pool_win, plan.width, plan.mt,
                                     plan.wpp, plan.stages,
                                     _LOG2E / math.sqrt(scale_width or hd), stream_ptr(q))
    else:
        err = lib.cv_flash_attn_f32(*ptrs, b * h, nq, nk, hd, pool_win,
                                    1.0 / math.sqrt(scale_width or hd), stream_ptr(q))
    check(err, "flash_attn")
    flash_attn.launches += 1
    return out


flash_attn.launches = 0
