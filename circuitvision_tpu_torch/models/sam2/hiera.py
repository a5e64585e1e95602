"""Hiera image trunk (SAM 2.1) in PyTorch, NHWC.

Counterpart of the JAX package's `models/sam2/hiera.py`, with its
execution plan kept exactly:

  * layout-persistent windows: consecutive blocks of one window size run
    on the partitioned (B·nW, win, win, C) tensor, and the map is
    re-partitioned only at window changes, q-pool blocks, global blocks
    and stage outputs (JAX hiera.py:676-752);
  * a q-pool transition block keeps the PREVIOUS stage's window
    (hiera.py:708-716);
  * a window that does not divide the map takes the padded-window module
    path (hiera.py:720-731) — at t@512 stages 3 and 4, whose windows 14
    and 7 do not divide 32² and 16²;
  * a global block of at least FLASH_MIN_SEQ tokens (the Hiera-L@1024
    blocks 23/33/43, 4096 tokens) runs LN1 + qkv, flash attention and
    proj + residual as kernels (hiera.py:454-492); shorter ones (t@512,
    1024 tokens) use einsum attention on the module path;
  * the background positional embedding is resized by torch bicubic
    (hiera.py:574 emulates exactly this in JAX).

The kernels of the port carry the blocks the JAX package gives to its
Pallas kernels: `mlp_block` in every block, `window_attn_block` in
partitioned blocks, `qpool_attn_block` in transition blocks whose even
window divides the map, `ln_qkv` → `flash_attn` → `attn_proj_residual`
(`window_attn_block_tiled`) in long global blocks of head width up to
MAX_HEAD_DIM. Everything else is the plain module path. In bfloat16 the
one-block window and q-pool kernels take head widths 56, 72 and 96 and
the tiled route every other width up to 256, padded to a multiple of 8
where it is not one (ops/cuda/window_attn.py `pad_heads`). A bfloat16
block on the card whose width is not a multiple of 8 — the tensor-core
kernels copy rows in 16-byte pieces — runs them in bfloat16 on rows
zero-padded to the next multiple of 8, with its weights and LayerNorm
parameters padded to match and each LayerNorm dividing by the true
width (`pad_block`; its window and q-pool halves take the tiled route),
and cuts its output back. The analyzer
refuses on the card only a bfloat16 trunk of heads wider than 256
(`refused_head_width`).

Training (train/train_step.py) needs gradients, and only FlashAttention
has a backward. `force_fused` is the counterpart of the JAX package's
gate of the same name (JAX hiera.py:156-198): False puts every block and the
refinement head on the plain module path; an int N keeps the kernels in
trunk blocks before N — the frozen prefix of a selective step, which
builds no graph — and puts blocks from N on, and every other kernel
site, on the module path; None (the default, serving) keeps the kernels
wherever the shapes take them. On the module path, attention over at
least FLASH_MIN_SEQ tokens goes through `FlashAttention` (the flash
kernel with its backward kernels on the card, its plain version on the
CPU), shorter sequences through `einsum_attention`, as the JAX module
path takes flash or einsum (`flash_route`; `force_flash` overrides the
choice). On the card FlashAttention takes float32 heads up to 128 but
bfloat16 heads only a multiple of 8 up to 96 — every SAM2.1 preset's
global heads (L 72, b+ 56, t and s 96) — and the training steps refuse a
model past that before their first step (train/train_step.py
`check_flash_widths`).
Every other kernel wrapper raises when an operand requires grad under
grad mode, so a kernel can never cut a gradient silently.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.cuda.flash_attn import MAX_HEAD_DIM, TC_WIDTHS, flash_attention
from ...ops.cuda.fused_ln import fused_add_layernorm, fused_layernorm
from ...ops.cuda.mlp_block import mlp_block
from ...ops.cuda.window_attn import (
    padded_head_width, qpool_attn_block, window_attn_block, window_attn_block_tiled,
)

#: global blocks of at least this many tokens take the flash route (JAX
#: hiera.py:201)
FLASH_MIN_SEQ = 2048

#: the kernel gate (`force_fused`) and the module path's attention choice
#: (`force_flash`); None: the defaults
_FORCE_FUSED = None
_FORCE_FLASH = None


@contextlib.contextmanager
def force_fused(value):
    """Scope the kernel gate: False puts every block and the refinement
    head on the module path, True or None keeps the kernels wherever the
    shapes take them, and an int N marks the start of the differentiable
    tail — trunk blocks before N keep their kernels, blocks from N on and
    every non-trunk kernel site take the module path (`fused_gate`)."""
    global _FORCE_FUSED
    old = _FORCE_FUSED
    _FORCE_FUSED = value
    try:
        yield
    finally:
        _FORCE_FUSED = old


def fused_gate(block_index: int | None = None) -> bool:
    """Whether the call site of trunk block `block_index` (None: a
    non-trunk site such as the refinement head) may take its kernels."""
    f = _FORCE_FUSED
    if f is None or isinstance(f, bool):
        return f is None or f
    return block_index is not None and 0 <= block_index < f


@contextlib.contextmanager
def force_flash(value):
    """Scope the module path's attention choice: True forces
    FlashAttention, False einsum attention, None restores the default
    (FlashAttention from FLASH_MIN_SEQ tokens at head widths up to
    MAX_HEAD_DIM)."""
    global _FORCE_FLASH
    old = _FORCE_FLASH
    _FORCE_FLASH = value
    try:
        yield
    finally:
        _FORCE_FLASH = old


def flash_route(tokens: int, hd: int) -> bool:
    """Whether the module path's attention over `tokens` query tokens of
    head width hd goes through FlashAttention (else einsum_attention):
    from FLASH_MIN_SEQ tokens, at head widths up to MAX_HEAD_DIM. On the
    card FlashAttention then takes every such float32 head but only
    bfloat16 heads a multiple of 8 up to 96 (flash_attn.grad_head_width_ok)
    and raises on any other; the training steps refuse such a model before
    their first step (train/train_step.py `check_flash_widths`)."""
    return tokens >= FLASH_MIN_SEQ and hd <= MAX_HEAD_DIM


def flash_blocks(trunk: "Hiera", resolution: int, start: int = 0) -> list[tuple[int, int, int]]:
    """(block index, query tokens, head width) of every trunk block from
    `start` on whose module-path attention takes FlashAttention
    (`flash_route`) on images of `resolution` pixels: a global block
    attends over its whole map, a windowed one over a window (a q-pool
    block over the pooled window), as `Hiera.forward` runs them."""
    side = (resolution - 1) // 4 + 1  # patch_embed_proj: kernel 7, stride 4, padding 3
    stage, out = 0, []
    for i in range(trunk.depth):
        window = trunk.window_spec[stage]  # a q-pool block keeps the previous stage's
        if i in trunk.q_pool_blocks:
            stage += 1
        if i in trunk.global_att_blocks:
            window = 0
        block = getattr(trunk, f"blocks_{i}")
        if block.q_stride:
            side, window = side // 2, window // 2
        tokens = window * window if window else side * side
        hd = block.dim_out // block.num_heads
        if i >= start and flash_route(tokens, hd):
            out.append((i, tokens, hd))
    return out


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A LayerNorm parameter as the kernels read it: float32 (a training
    config may hold it in bfloat16; bfloat16 → float32 is exact)."""
    return t if t.dtype == torch.float32 else t.float()


def window_partition(x: torch.Tensor, window: int):
    """(B, H, W, C) → (B·nW, win, win, C) with bottom/right zero padding."""
    b, h, w, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - w % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
    return x, (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // ((hp // window) * (wp // window))
    x = windows.reshape(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w, :].contiguous()


def _pool2x(x: torch.Tensor) -> torch.Tensor:
    """2×2 max-pool of (B, H, W, C)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class TrunkLayerNorm(nn.Module):
    """LayerNorm with f32 fast-variance statistics (E[x²]−mean²), output
    in the input dtype (JAX hiera.TrunkLayerNorm at true_dim == C); scale
    and bias in float32 storage (models/layers.place).

    `forward(x, residual=r)` computes the Hiera block's join r + x in the
    input dtype and returns (r + x, LN(r + x)). With `fused` on and a CUDA
    tensor, the `fused_layernorm` / `fused_add_layernorm` kernels compute
    it in one pass (JAX hiera.py:102-116); otherwise the module math runs.
    The trunk builds its norms unfused, as the JAX trunk does."""

    float32_params = True

    def __init__(self, dim: int, eps: float = 1e-6, fused: bool = False):
        super().__init__()
        self.eps = eps
        self.fused = fused
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None):
        if self.fused and x.is_cuda:
            shape, c = x.shape, x.shape[-1]
            x2 = x.reshape(-1, c).contiguous()
            if residual is not None:
                resid, y = fused_add_layernorm(residual.reshape(-1, c).contiguous(), x2,
                                               self.weight, self.bias, self.eps)
                return resid.reshape(shape), y.reshape(shape)
            return fused_layernorm(x2, self.weight, self.bias, self.eps).reshape(shape)
        if residual is not None:
            x = residual + x
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = (y * self.weight + self.bias).to(x.dtype)
        return y if residual is None else (x, y)


def einsum_attention(q, k, v, scale: float) -> torch.Tensor:
    """(B, N, H, D) attention: f32 scores and softmax, probabilities in
    v's dtype for the p·v product."""
    attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    attn = torch.softmax(attn * scale, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int):
        super().__init__()
        self.dim_out = dim_out
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim_out * 3)
        self.proj = nn.Linear(dim_out, dim_out)

    def forward(self, x: torch.Tensor, q_pool: bool) -> torch.Tensor:
        b, h, w, _ = x.shape
        hd = self.dim_out // self.num_heads
        qkv = self.qkv(x).reshape(b, h * w, 3, self.num_heads, hd)
        q, k, v = qkv.unbind(2)
        if q_pool:
            q = _pool2x(q.reshape(b, h, w, -1))
            h, w = q.shape[1], q.shape[2]
            q = q.reshape(b, h * w, self.num_heads, hd)
        flash = _FORCE_FLASH if _FORCE_FLASH is not None else flash_route(q.shape[1], hd)
        if flash:
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2)).transpose(1, 2)
        else:
            out = einsum_attention(q, k, v, hd ** -0.5)
        return self.proj(out.reshape(b, h, w, self.dim_out))


class MultiScaleBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int, q_stride: bool,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.dim, self.dim_out, self.num_heads = dim, dim_out, num_heads
        self.q_stride = q_stride
        self.norm1 = TrunkLayerNorm(dim)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)
        self.norm2 = TrunkLayerNorm(dim_out)
        hidden = int(dim_out * mlp_ratio)
        self.mlp_layers_0 = nn.Linear(dim_out, hidden)
        self.mlp_layers_1 = nn.Linear(hidden, dim_out)
        #: position in the trunk, for the kernel gate (`fused_gate`); -1: a
        #: block of its own, on the module path whenever a cutoff is set
        self.block_index = -1
        self._padded: dict[str, torch.Tensor] = {}
        self._padded_key: tuple = ()

    def padded_params(self) -> dict[str, torch.Tensor]:
        """The parameters as the padded route (`pad_block`) reads them:
        the LayerNorms' scales and biases (float32) and the input columns
        of qkv and of the shortcut projection zero-padded to the next
        multiple of 8 of their width, the MLP's weights and biases padded
        likewise on both sides (its hidden width too, where that is off a
        multiple of 8), attn.proj at its true width (the tiled route pads
        its heads itself, window_attn.pad_heads). Padded on the first
        call, and again only once a parameter has been moved or written
        (its storage or version changed)."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._padded_key != key:
            p = {n: t.detach() for n, t in self.named_parameters()}
            ci, co = _ceil8(self.dim), _ceil8(self.dim_out)
            hidden = self.mlp_layers_0.out_features
            hp = _ceil8(hidden)
            out = {
                "norm1.weight": _pad_last(_f32(p["norm1.weight"]), ci),
                "norm1.bias": _pad_last(_f32(p["norm1.bias"]), ci),
                "attn.qkv.weight": _pad_last(p["attn.qkv.weight"], ci),
                "attn.qkv.bias": p["attn.qkv.bias"],
                "attn.proj.weight": p["attn.proj.weight"],
                "attn.proj.bias": p["attn.proj.bias"],
                "norm2.weight": _pad_last(_f32(p["norm2.weight"]), co),
                "norm2.bias": _pad_last(_f32(p["norm2.bias"]), co),
                "mlp_layers_0.weight": F.pad(p["mlp_layers_0.weight"],
                                             (0, co - self.dim_out, 0, hp - hidden)),
                "mlp_layers_0.bias": _pad_last(p["mlp_layers_0.bias"], hp),
                "mlp_layers_1.weight": F.pad(p["mlp_layers_1.weight"],
                                             (0, hp - hidden, 0, co - self.dim_out)),
                "mlp_layers_1.bias": _pad_last(p["mlp_layers_1.bias"], co),
            }
            if self.dim != self.dim_out:
                out["proj.weight"] = _pad_last(p["proj.weight"], ci)
                out["proj.bias"] = p["proj.bias"]
            self._padded, self._padded_key = out, key
        return self._padded

    def attention_path(self, x: torch.Tensor, window_size: int, partitioned: bool) -> str:
        """Which path the attention half of `forward` takes: "qpool",
        "global" or "window" (the kernels) or "module" (the plain module
        path), by shape alone — whatever the dtype or head width, so a
        CUDA tensor at a width the kernels refuse raises in the wrapper.
        Global blocks of head width above MAX_HEAD_DIM (flash_attn's
        widest) take the module path, as the JAX trunk's do."""
        heads = self.num_heads
        if (self.q_stride and window_size > 0 and window_size % 2 == 0
                and x.shape[1] % window_size == 0 and x.shape[2] % window_size == 0
                and self.dim != self.dim_out and self.dim_out % heads == 0):
            return "qpool"
        if (window_size == 0 and not partitioned and not self.q_stride
                and self.dim == self.dim_out and self.dim % heads == 0
                and self.dim // heads <= MAX_HEAD_DIM
                and x.shape[1] * x.shape[2] >= FLASH_MIN_SEQ):
            return "global"
        if partitioned and not self.q_stride and self.dim == self.dim_out \
                and self.dim_out % heads == 0:
            return "window"
        return "module"

    def forward(self, x: torch.Tensor, window_size: int, partitioned: bool) -> torch.Tensor:
        """x is (B, H, W, C) in full layout (`window_size` > 0 windows it
        here, 0 is global) or, when `partitioned`, (B·nW, win, win, C)
        with each window an image of its own. A bfloat16 CUDA block of a
        width off a multiple of 8 runs its kernels on rows zero-padded to
        the next multiple of 8 (`pad_block`, `padded_params`), each
        LayerNorm dividing by the true width, and cuts its output back."""
        kernels = fused_gate(self.block_index if self.block_index >= 0 else None)
        padded = kernels and pad_block(x, self.dim, self.dim_out)
        if padded:
            p, ln_in, ln_out = self.padded_params(), self.dim, self.dim_out
            x = _pad_last(x, _ceil8(self.dim))
        else:
            p, ln_in, ln_out = self._params(), None, None
        heads = self.num_heads
        path = self.attention_path(x, window_size, partitioned) if kernels else "module"
        if path == "qpool":
            _b, fh, fw, c = x.shape
            win = window_size
            xw, _ = window_partition(x, win)
            nwm = xw.shape[0]
            out = qpool_attn_block(
                xw.reshape(nwm * win * win, c).contiguous(),
                _f32(p["norm1.weight"]), _f32(p["norm1.bias"]), p["proj.weight"],
                p["proj.bias"], p["attn.qkv.weight"], p["attn.qkv.bias"],
                p["attn.proj.weight"], p["attn.proj.bias"],
                heads=heads, win=win, ln_width=ln_in,
            )
            x = out.reshape(nwm, win // 2, win // 2, self.dim_out)
            x = window_unpartition(x, win // 2, (fh // 2, fw // 2), (fh // 2, fw // 2))
        elif path == "global":
            b_, fh, fw, c = x.shape
            x = window_attn_block_tiled(
                x.reshape(b_, fh * fw, c).contiguous(), _f32(p["norm1.weight"]),
                _f32(p["norm1.bias"]), p["attn.qkv.weight"], p["attn.qkv.bias"],
                p["attn.proj.weight"], p["attn.proj.bias"], heads, round_proj=False,
                ln_width=ln_in).reshape(b_, fh, fw, -1)
        elif path == "window":
            b_, wh, ww, c = x.shape
            x = window_attn_block(
                x.reshape(b_, wh * ww, c).contiguous(),
                _f32(p["norm1.weight"]), _f32(p["norm1.bias"]),
                p["attn.qkv.weight"], p["attn.qkv.bias"],
                p["attn.proj.weight"], p["attn.proj.bias"],
                heads=heads, ln_width=ln_in,
            ).reshape(b_, wh, ww, -1)
        else:
            x = self._module_attention(x[..., :self.dim] if padded else x, window_size,
                                       partitioned)
        if not kernels:
            y = F.gelu(self.mlp_layers_0(self.norm2(x)))
            return x + self.mlp_layers_1(y)
        if padded:
            x = _pad_last(x[..., :self.dim_out], _ceil8(self.dim_out))
        shp = x.shape
        out = mlp_block(
            x.reshape(-1, shp[-1]).contiguous(), _f32(p["norm2.weight"]),
            _f32(p["norm2.bias"]), p["mlp_layers_0.weight"], p["mlp_layers_0.bias"],
            p["mlp_layers_1.weight"], p["mlp_layers_1.bias"], ln_width=ln_out,
        ).reshape(shp)
        return out[..., :self.dim_out].contiguous() if padded else out

    def _params(self) -> dict[str, torch.Tensor]:
        """The parameters the kernels read, by their state-dict names."""
        p = {"norm1.weight": self.norm1.weight, "norm1.bias": self.norm1.bias,
             "attn.qkv.weight": self.attn.qkv.weight, "attn.qkv.bias": self.attn.qkv.bias,
             "attn.proj.weight": self.attn.proj.weight, "attn.proj.bias": self.attn.proj.bias,
             "norm2.weight": self.norm2.weight, "norm2.bias": self.norm2.bias,
             "mlp_layers_0.weight": self.mlp_layers_0.weight,
             "mlp_layers_0.bias": self.mlp_layers_0.bias,
             "mlp_layers_1.weight": self.mlp_layers_1.weight,
             "mlp_layers_1.bias": self.mlp_layers_1.bias}
        if self.dim != self.dim_out:
            p["proj.weight"], p["proj.bias"] = self.proj.weight, self.proj.bias
        return p

    def _module_attention(self, x: torch.Tensor, window_size: int,
                          partitioned: bool) -> torch.Tensor:
        """The attention half on the plain module path: x + attn(LN1(x)),
        the shortcut projected and pooled in a transition block."""
        shortcut = x
        x = self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = _pool2x(self.proj(x))
        window = 0 if partitioned else window_size
        pad_hw = None
        hw = (x.shape[1], x.shape[2])
        if window > 0:
            x, pad_hw = window_partition(x, window)
        x = self.attn(x, self.q_stride)
        if self.q_stride:
            # q was pooled: windows halve and the padded grid with them
            window = window // 2
            hw = (shortcut.shape[1], shortcut.shape[2])
            if pad_hw is not None:
                pad_hw = (pad_hw[0] // 2, pad_hw[1] // 2)
        if window > 0:
            x = window_unpartition(x, window, pad_hw, hw)
        return shortcut + x


def pad_block(x: torch.Tensor, dim: int, dim_out: int) -> bool:
    """Whether a block of widths dim → dim_out runs its kernels on padded
    rows: a bfloat16 CUDA tensor at a width off a multiple of 8, which
    the tensor-core kernels (rows copied in 16-byte pieces) take only
    zero-padded to the next multiple of 8. On the CPU the plain versions
    take every width."""
    return x.is_cuda and x.dtype == torch.bfloat16 and bool(dim % 8 or dim_out % 8)


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _pad_last(t: torch.Tensor, width: int) -> torch.Tensor:
    """t zero-padded on its last axis to `width` (t itself at that width)."""
    return F.pad(t, (0, width - t.shape[-1])) if t.shape[-1] < width else t


def refused_head_width(embed_dim: int, num_heads: int) -> int | None:
    """The head width of a Hiera trunk — embed_dim // num_heads in every
    stage, since a q-pool block doubles both — if its bfloat16 kernels
    refuse it, else None: padded to a multiple of 8, wider than
    flash_attn's widest bf16 instance (TC_WIDTHS[-1])."""
    hd = embed_dim // num_heads
    return hd if padded_head_width(hd, torch.bfloat16) > TC_WIDTHS[-1] else None


class Hiera(nn.Module):
    """Hiera trunk. Input (B, S, S, 3); returns 4 feature maps
    high-res-first: strides 4/8/16/32, dims d, 2d, 4d, 8d."""

    def __init__(self, embed_dim=144, num_heads=2, stages=(2, 6, 36, 4),
                 global_att_blocks=(23, 33, 43), window_pos_embed_bkg_spatial_size=(7, 7),
                 window_spec=(8, 4, 16, 8)):
        super().__init__()
        self.stages = tuple(stages)
        self.global_att_blocks = tuple(global_att_blocks)
        self.window_spec = tuple(window_spec)
        self.patch_embed_proj = nn.Conv2d(3, embed_dim, 7, 4, 3)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, *window_pos_embed_bkg_spatial_size, embed_dim))
        self.pos_embed_window = nn.Parameter(
            torch.zeros(1, window_spec[0], window_spec[0], embed_dim))
        stage_ends = [sum(self.stages[: i + 1]) - 1 for i in range(len(self.stages))]
        self.stage_ends = stage_ends
        self.q_pool_blocks = [e + 1 for e in stage_ends[:-1]]
        self.depth = sum(self.stages)
        dim, heads = embed_dim, num_heads
        for i in range(self.depth):
            dim_out = dim
            if i in self.q_pool_blocks:
                dim_out, heads = dim * 2, heads * 2
            block = MultiScaleBlock(dim, dim_out, heads, i in self.q_pool_blocks)
            block.block_index = i
            self.add_module(f"blocks_{i}", block)
            dim = dim_out

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        dt = self.patch_embed_proj.weight.dtype
        x = self.patch_embed_proj(x.to(dt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        _b, h, w, _ = x.shape
        pos = F.interpolate(self.pos_embed.float().permute(0, 3, 1, 2), size=(h, w),
                            mode="bicubic", align_corners=False).permute(0, 2, 3, 1)
        ws0 = self.window_spec[0]
        pos = pos + self.pos_embed_window.float().repeat(1, h // ws0, w // ws0, 1)
        x = x + pos.to(x.dtype)

        cur_stage = 0
        outputs: list[torch.Tensor] = []
        part_window = 0  # 0 ⇒ full (B, H, W, C) layout
        full_hw = (x.shape[1], x.shape[2])

        def to_full(x):
            nonlocal part_window
            if part_window:
                x = window_unpartition(x, part_window, full_hw, full_hw)
                part_window = 0
            return x

        for i in range(self.depth):
            # read before the stage bump: a transition block keeps the
            # previous stage's window
            window = self.window_spec[cur_stage]
            is_q_pool = i in self.q_pool_blocks
            if is_q_pool:
                cur_stage += 1
            if i in self.global_att_blocks:
                window = 0
            divisible = window > 0 and full_hw[0] % window == 0 and full_hw[1] % window == 0
            want_part = window if (divisible and not is_q_pool) else 0
            if part_window != want_part:
                x = to_full(x)
                if want_part:
                    x, _ = window_partition(x, want_part)
                    part_window = want_part
            x = getattr(self, f"blocks_{i}")(x, 0 if part_window else window, bool(part_window))
            if is_q_pool:
                full_hw = (x.shape[1], x.shape[2])
            if i in self.stage_ends:
                x = to_full(x)
                outputs.append(x)
        return outputs
