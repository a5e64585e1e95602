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

`FlashAttention` is the same attention with a gradient, for training
(the Hiera global blocks on the module path, models/sam2/hiera.py): its
forward launches the kernel's lse instance (`flash_attn_lse`, which also
writes each row's log-sum-exp), its backward the two kernels of
csrc/flash_bwd.cu (`flash_attn_bwd_dq`, then `flash_attn_bwd_dkv`),
which replace jax's `_flash_attention_bwd_dq` and `_bwd_dkv`;
`flash_attn_bwd_plain` is their plain version. Every other kernel wrapper
of the port raises under autograd (build.check_no_grad). On the card a
bfloat16 head off a multiple of 8 takes FlashAttention's padded route:
q, k, v and dO zero-padded to the next multiple of 8, the kernels run
with the softmax scale of the true width (`scale_width`), o, dQ, dK and
dV cut back; the zero columns change no score, no probability and no
row sum, so the route computes what the unpadded attention does.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from .build import (
    MAX_SMEM, KernelError, check, check_aligned, check_no_grad, check_operands, dtype_code,
    library, sm_count, stream_ptr,
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
    check_no_grad("flash_attn", q, k, v)
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


# ------------------------------------------------------- with a gradient
#: head widths of the bfloat16 instances of FlashAttention's kernels: the
#: lse forward (csrc/flash_attn.cu cv_flash_attn_lse_bf16) and the two
#: backward kernels (csrc/flash_bwd.cu kBwdWidths). A head a multiple of
#: 8 takes the narrowest that holds it, its extra columns zero (`grad_width`):
#: 72 takes SAM2.1-L's and -b+'s global heads (72, 56), 96 Hiera-t's and
#: -s's, 128 every head of 97 to 128
LSE_WIDTHS = (72, 96, 128)
#: the backward kernels' widest heads: bfloat16 and float32 128
BWD_WIDEST = {torch.bfloat16: LSE_WIDTHS[-1], torch.float32: MAX_HEAD_DIM}
#: q rows (dq) or keys (dkv) a block of the bfloat16 backward kernels,
#: one m16 tile of them a warp; keys (dq) or q rows (dkv) a streamed tile
BWD_TILE = 64


def grad_width(hd: int) -> int:
    """The bfloat16 instance of FlashAttention's kernels that takes heads
    of width hd: the narrowest of LSE_WIDTHS that holds it. Raises where
    hd is not a multiple of 8 (rows are copied in 16-byte pieces) or wider
    than every instance."""
    if hd < 8 or hd % 8 or hd > LSE_WIDTHS[-1]:
        raise KernelError(f"FlashAttention: bfloat16 head width {hd} is not a multiple of 8 "
                          f"up to {LSE_WIDTHS[-1]}")
    return next(w for w in LSE_WIDTHS if w >= hd)


def flash_bwd_tc_smem(width: int) -> int:
    """Shared-memory bytes of a block of either bfloat16 backward kernel at
    instance width `width` (csrc/flash_bwd.cu bwd_tc_smem, which the card
    tests compare): six 64-row bf16 tiles of rows of the padded depth plus
    8, and 1 KB of float32 row values (lse and D of two staged q tiles)."""
    return 2 * 6 * BWD_TILE * (tc_depth(width) + 8) + 4 * 4 * BWD_TILE


def grad_head_width_ok(hd: int, dtype: torch.dtype) -> bool:
    """Whether FlashAttention takes heads of width hd in dtype on the
    card: float32 and bfloat16 up to MAX_HEAD_DIM (a bfloat16 head off a
    multiple of 8 on the padded route, `grad_pad_width`). On the CPU the
    plain versions take every width."""
    return dtype in (torch.bfloat16, torch.float32) and 0 < hd <= MAX_HEAD_DIM


def grad_pad_width(hd: int, dtype: torch.dtype, device: torch.device) -> int:
    """The head width FlashAttention hands its kernels: a bfloat16 head
    on the card off a multiple of 8 (the kernels copy rows in 16-byte
    pieces) is zero-padded to the next multiple; every other head is
    taken as it is."""
    if dtype == torch.bfloat16 and device.type == "cuda" and hd % 8:
        return -(-hd // 8) * 8
    return hd


def _kernel_width_ok(hd: int, dtype: torch.dtype) -> bool:
    """Whether the lse forward's kernel takes heads of width hd: float32
    up to MAX_HEAD_DIM, bfloat16 a multiple of 8 up to LSE_WIDTHS[-1]."""
    if dtype == torch.bfloat16:
        return 8 <= hd <= LSE_WIDTHS[-1] and hd % 8 == 0
    return dtype == torch.float32 and 0 < hd <= MAX_HEAD_DIM


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """The plain versions' arithmetic: float64 for float64 inputs (the
    gradient checks), float32 otherwise."""
    return torch.float64 if dt == torch.float64 else torch.float32


def flash_attn_lse_plain(q, k, v, scale_width=None):
    """(o, lse): flash_attn_plain's o (the probabilities normalised in the
    accumulation dtype, then rounded to the compute dtype) and each row's
    log-sum-exp of the scaled scores, (B, H, Nq) in float32 (float64 for
    float64 inputs)."""
    dt, acc = q.dtype, _acc_dtype(q.dtype)
    b, h, nq, hd = q.shape
    scale = (scale_width or hd) ** -0.5
    kf, vf = k.to(acc), v.to(acc)
    out = torch.empty((b, h, nq, hd), dtype=dt, device=q.device)
    lse = torch.empty((b, h, nq), dtype=acc, device=q.device)
    step = max(1, _PLAIN_CHUNK // (b * h * k.shape[2]))
    for i in range(0, nq, step):
        s = (q[:, :, i:i + step].to(acc) @ kf.transpose(-1, -2)) * scale
        lse[:, :, i:i + step] = torch.logsumexp(s, dim=-1)
        p = torch.softmax(s, dim=-1).to(dt)
        out[:, :, i:i + step] = (p.to(acc) @ vf).to(dt)
    return out, lse


def flash_attn_lse(q, k, v, scale_width=None):
    """The forward of FlashAttention: (o, lse) for q (B, H, Nq, D), k and
    v (B, H, Nk, D), lse (B, H, Nq) float32. CPU tensors take the plain
    version; CUDA tensors launch flash_attn's lse instance (bfloat16: D a
    multiple of 8 up to 128, on the narrowest of LSE_WIDTHS that holds it;
    float32: D ≤ 128)."""
    if q.device.type == "cpu":
        return flash_attn_lse_plain(q, k, v, scale_width)
    check_operands("flash_attn_lse", q, k, v)
    check_no_grad("flash_attn_lse", q, k, v)
    b, h, nq, hd = q.shape
    nk = k.shape[2]
    if k.shape != (b, h, nk, hd) or v.shape != k.shape or nk < 1 \
            or not _kernel_width_ok(hd, q.dtype):
        raise KernelError(f"flash_attn_lse: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                          f"v {tuple(v.shape)} do not fit (heads: float32 up to "
                          f"{MAX_HEAD_DIM}, bfloat16 a multiple of 8 up to "
                          f"{LSE_WIDTHS[-1]})")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    lib = library("flash_attn")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr())
    if q.dtype == torch.bfloat16:
        plan = flash_plan(b * h, nq, nk, grad_width(hd), sm_count(q))
        check_aligned("flash_attn_lse", q, k, v, out)
        err = lib.cv_flash_attn_lse_bf16(*ptrs, b * h, nq, nk, hd, plan.width, plan.mt,
                                         plan.wpp, plan.stages,
                                         _LOG2E / math.sqrt(scale_width or hd), stream_ptr(q))
    else:
        err = lib.cv_flash_attn_lse_f32(*ptrs, b * h, nq, nk, hd,
                                        1.0 / math.sqrt(scale_width or hd), stream_ptr(q))
    check(err, "flash_attn_lse")
    flash_attn_lse.launches += 1
    return out, lse


flash_attn_lse.launches = 0


def flash_attn_bwd_plain(q, k, v, o, lse, do, scale_width=None):
    """(dq, dk, dv) of o = softmax(q·kᵀ·s)·v for the output gradient do,
    from the forward's lse: P = exp(q·kᵀ·s − lse), dV = Pᵀ·dO,
    dS = P∘(dO·Vᵀ − rowsum(dO∘O))·s, dQ = dS·K, dK = dSᵀ·Q — in float32
    (float64 for float64 inputs) over chunks of q rows. As jax's backward
    kernels (flash_attention.py :900, :918, :1251-1258), P and dS are
    rounded to the inputs' dtype where they enter the products (a no-op in
    float32 and float64), the sums kept in the accumulation dtype and each
    result rounded once."""
    acc = _acc_dtype(q.dtype)
    return _bwd_plain(q, k, v, lse, (do.to(acc) * o.to(acc)).sum(-1), do, scale_width)


def _bwd_plain(q, k, v, lse, delta, do, scale_width):
    """flash_attn_bwd_plain given delta = rowsum(do∘o)."""
    dt, acc = q.dtype, _acc_dtype(q.dtype)
    b, h, nq, hd = q.shape
    scale = (scale_width or hd) ** -0.5
    kf, vf = k.to(acc), v.to(acc)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=acc, device=q.device)
    dv = torch.zeros(v.shape, dtype=acc, device=q.device)
    step = max(1, _PLAIN_CHUNK // (b * h * k.shape[2]))
    for i in range(0, nq, step):
        qf, dof = q[:, :, i:i + step].to(acc), do[:, :, i:i + step].to(acc)
        p = torch.exp((qf @ kf.transpose(-1, -2)) * scale - lse[:, :, i:i + step, None].to(acc))
        dv += p.to(dt).to(acc).transpose(-1, -2) @ dof
        ds = p * (dof @ vf.transpose(-1, -2) - delta[:, :, i:i + step, None].to(acc))
        ds = (ds * scale).to(dt).to(acc)
        dq[:, :, i:i + step] = (ds @ kf).to(dt)
        dk += ds.transpose(-1, -2) @ qf
    return dq, dk.to(dt), dv.to(dt)


def _bwd_operands(what, q, k, v, lse, do, *more):
    check_operands(what, q, k, v, do, *more)
    check_no_grad(what, q, k, v, lse, do, *more)
    b, h, nq, hd = q.shape
    nk = k.shape[2]
    widest = BWD_WIDEST.get(q.dtype, 0)
    if k.shape != (b, h, nk, hd) or v.shape != k.shape or do.shape != q.shape or nk < 1 \
            or hd > widest or any(t.shape != q.shape for t in more):
        raise KernelError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)},"
                          f" do {tuple(do.shape)} do not fit (widest {q.dtype} head {widest})")
    if q.dtype == torch.bfloat16:
        grad_width(hd)  # raises on a width no instance takes
        check_aligned(what, q, k, v, do, *more)
    if lse.dtype != torch.float32 or lse.shape != (b, h, nq) or not lse.is_contiguous() \
            or lse.device != q.device:
        raise KernelError(f"{what}: lse must be contiguous float32 ({b}, {h}, {nq}) on "
                          f"{q.device}; got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    return b, h, nq, nk, hd


def flash_attn_bwd_dq(q, k, v, o, lse, do, scale_width=None):
    """(dq, delta): the gradient of q and delta = rowsum(do∘o) (B, H, Nq)
    float32, which flash_attn_bwd_dkv reads. CPU tensors take the plain
    version; CUDA tensors launch csrc/flash_bwd.cu's dq kernel (float32:
    D ≤ 128; bfloat16: D a multiple of 8 up to 128, on the tensor cores)."""
    if q.device.type == "cpu":
        acc = _acc_dtype(q.dtype)
        delta = (do.to(acc) * o.to(acc)).sum(-1)
        return _bwd_plain(q, k, v, lse, delta, do, scale_width)[0], delta
    b, h, nq, nk, hd = _bwd_operands("flash_attn_bwd_dq", q, k, v, lse, do, o)
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    err = library("flash_bwd").cv_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        dq.data_ptr(), delta.data_ptr(), b * h, nq, nk, hd,
        1.0 / math.sqrt(scale_width or hd), dtype_code(q), stream_ptr(q))
    check(err, "flash_attn_bwd_dq")
    flash_attn_bwd_dq.launches += 1
    return dq, delta


flash_attn_bwd_dq.launches = 0


def flash_attn_bwd_dkv(q, k, v, lse, delta, do, scale_width=None):
    """(dk, dv) from lse and flash_attn_bwd_dq's delta. CPU tensors take
    the plain version; CUDA tensors launch csrc/flash_bwd.cu's dkv kernel
    on the stream that ran the dq kernel."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, lse, delta, do, scale_width)[1:]
    b, h, nq, nk, hd = _bwd_operands("flash_attn_bwd_dkv", q, k, v, lse, do)
    check_no_grad("flash_attn_bwd_dkv", delta)
    if delta.dtype != torch.float32 or delta.shape != lse.shape or not delta.is_contiguous() \
            or delta.device != q.device:
        raise KernelError(f"flash_attn_bwd_dkv: delta must be contiguous float32 "
                          f"{tuple(lse.shape)} on {q.device}; got {delta.dtype} "
                          f"{tuple(delta.shape)} on {delta.device}")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = library("flash_bwd").cv_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        do.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, nq, nk, hd,
        1.0 / math.sqrt(scale_width or hd), dtype_code(q), stream_ptr(q))
    check(err, "flash_attn_bwd_dkv")
    flash_attn_bwd_dkv.launches += 1
    return dk, dv


flash_attn_bwd_dkv.launches = 0


def _pad_head(t: torch.Tensor, width: int) -> torch.Tensor:
    """t (…, D) contiguous, zero-padded to `width` columns where D < width."""
    return F.pad(t, (0, width - t.shape[-1])) if width > t.shape[-1] else t.contiguous()


def _cut_head(t: torch.Tensor, hd: int) -> torch.Tensor:
    return t[..., :hd].contiguous() if t.shape[-1] > hd else t


class FlashAttention(torch.autograd.Function):
    """softmax(q·kᵀ·scale_width^-0.5)·v over q (B, H, Nq, D), k and v
    (B, H, Nk, D), with a gradient: the counterpart of jax's TPU flash
    attention with its custom VJP (flash_attention.py:204, defvjp :318).
    The forward saves (q, k, v, o, lse) from flash_attn_lse; the backward
    calls flash_attn_bwd_dq, then flash_attn_bwd_dkv. On the CPU the three
    wrappers take their plain versions. The one kernel path that may run
    under autograd; a kernel failure raises. On the card it takes heads
    of width up to 128 in float32 and bfloat16 (`grad_head_width_ok`).
    The kernels see heads of `grad_pad_width` (D but for a bfloat16 head
    on the card off a multiple of 8): q, k, v and dO are zero-padded to
    it, the scale stays the true width's (scale_width, default D), and o,
    dQ, dK and dV are cut back to D — the padded route, which JAX's kernel
    takes for every head (padded to 128 lanes,
    circuitvision_tpu/models/sam2/hiera.py:262-272)."""

    @staticmethod
    def forward(ctx, q, k, v, scale_width=None):
        hd = q.shape[-1]
        width = grad_pad_width(hd, q.dtype, q.device)
        scale_width = scale_width or hd
        q, k, v = (_pad_head(t, width) for t in (q, k, v))
        o, lse = flash_attn_lse(q, k, v, scale_width)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale_width, ctx.hd = scale_width, hd
        return _cut_head(o, hd)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = _pad_head(do, q.shape[-1])
        dq, delta = flash_attn_bwd_dq(q, k, v, o, lse, do, ctx.scale_width)
        dk, dv = flash_attn_bwd_dkv(q, k, v, lse, delta, do, ctx.scale_width)
        return _cut_head(dq, ctx.hd), _cut_head(dk, ctx.hd), _cut_head(dv, ctx.hd), None


def flash_attention(q, k, v, scale_width=None):
    """FlashAttention.apply: attention with a gradient (see the class)."""
    return FlashAttention.apply(q, k, v, scale_width)
