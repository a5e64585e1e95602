"""Gemma decoder (PaliGemma's language model) with a static KV cache: the
JAX package's `models/paligemma/gemma.py` in torch.

RMSNorm with (1 + weight) applied in float32, full-head-dim rotary
embeddings (rotate_half convention, θ = 10000), grouped-query attention
(Gemma-2B is MQA: one kv head broadcast over its q group by einsum, never
materialized), a GeGLU MLP with tanh-GELU, token embeddings scaled by
sqrt(hidden) cast to the compute dtype first (45.25 in bf16: that
rounding is part of the published numerics), and a weight-tied LM head
(the caller's). Attention logits are scaled after q·k in the compute
dtype; the additive mask is float32 with finfo(float32).min, and the
softmax runs in float32, cast to q's dtype.

The KV cache is a pair of (L, B, T_max, n_kv, head_dim) buffers
(`make_kv_cache`), written in place at `cache_index`: prefill and every
decode step run at fixed shapes. The JAX decoder is plain Flax with no
Pallas kernel, so this is plain torch: the products are cuBLAS's on the
card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.config import resolve_device
from .config import GemmaTextConfig
from .vision import gelu_tanh


class QuantDense(nn.Module):
    """Weight-only int8 linear: y = (x @ kernel_q) * scale.

    `kernel_q` is int8, stored (out, in) as a Linear weight, so this runs
    the same product as the float layer on the dequantized copy
    `kernel_q.to(dtype)`; the per-output-channel float32 `scale` multiplies
    the product in float32 after it (exact when the scale is a power of
    two), then the result is cast to the compute dtype. The plain product
    writes and reads that dequantized copy on every call."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("kernel_q", torch.zeros(out_features, in_features,
                                                     dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.kernel_q.to(self.dtype))
        return (y.float() * self.scale).to(self.dtype)


def _dense(quant: bool, in_features: int, out_features: int, dtype: torch.dtype) -> nn.Module:
    if quant:
        return QuantDense(in_features, out_features, dtype)
    return nn.Linear(in_features, out_features, bias=False, dtype=dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + self.eps)
        y = y * (1.0 + self.weight.float())
        return y.to(x.dtype)


def rope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float,
                 dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) int positions → cos/sin (B, S, head_dim), float32 math."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=position_ids.device) / head_dim))
    freqs = position_ids.float()[..., None] * inv_freq  # (B, S, hd/2)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, D) broadcast over heads."""
    return x * cos[:, :, None, :] + _rotate_half(x) * sin[:, :, None, :]


class GemmaAttention(nn.Module):
    def __init__(self, cfg: GemmaTextConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        c, q = cfg, cfg.quant_int8
        h, n_kv, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        self.q_proj = _dense(q, c.hidden_size, h * hd, dtype)
        self.k_proj = _dense(q, c.hidden_size, n_kv * hd, dtype)
        self.v_proj = _dense(q, c.hidden_size, n_kv * hd, dtype)
        self.o_proj = _dense(q, h * hd, c.hidden_size, dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                cache_index: int) -> torch.Tensor:
        """x (B, S, C); bias (B, S, T) float32 additive mask over cache
        slots; k_cache/v_cache (B, T, n_kv, hd), written in place at
        [cache_index, cache_index + S)."""
        c = self.cfg
        b, s, _ = x.shape
        h, n_kv, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        q = apply_rope(self.q_proj(x).view(b, s, h, hd), cos, sin)
        k = apply_rope(self.k_proj(x).view(b, s, n_kv, hd), cos, sin)
        v = self.v_proj(x).view(b, s, n_kv, hd)
        k_cache[:, cache_index:cache_index + s] = k
        v_cache[:, cache_index:cache_index + s] = v

        qg = q.view(b, s, n_kv, h // n_kv, hd)
        # (B, S, n_kv, groups, T): kv heads broadcast across their q groups
        logits = torch.einsum("bsngd,btnd->bsngt", qg, k_cache) * (hd ** -0.5)
        logits = logits.float() + bias[:, :, None, None, :]
        w = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bsngt,btnd->bsngd", w, v_cache).reshape(b, s, h * hd)
        return self.o_proj(out)


class GemmaDecoderLayer(nn.Module):
    def __init__(self, cfg: GemmaTextConfig, dtype: torch.dtype):
        super().__init__()
        c, q = cfg, cfg.quant_int8
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.self_attn = GemmaAttention(c, dtype)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.gate_proj = _dense(q, c.hidden_size, c.intermediate_size, dtype)
        self.up_proj = _dense(q, c.hidden_size, c.intermediate_size, dtype)
        self.down_proj = _dense(q, c.intermediate_size, c.hidden_size, dtype)

    def forward(self, x, bias, cos, sin, k_cache, v_cache, cache_index):
        x = x + self.self_attn(self.input_layernorm(x), bias, cos, sin, k_cache, v_cache,
                               cache_index)
        y = self.post_attention_layernorm(x)
        return x + self.down_proj(gelu_tanh(self.gate_proj(y)) * self.up_proj(y))


class GemmaDecoder(nn.Module):
    """Runs the layer stack over (possibly image-substituted) embeddings.

    Call with inputs_embeds (B, S, C) UNSCALED (the sqrt(hidden)
    normalizer is applied here, after any image substitution), a
    (B, S, T) float32 additive bias over cache slots, (B, S) position ids
    (PaliGemma: cache position + 1) and the (L, B, T, n_kv, hd) k/v
    cache pair, written in place. Returns the final-norm hidden states;
    the caller takes logits against the tied embedding."""

    def __init__(self, cfg: GemmaTextConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        # sqrt(hidden) rounded to the compute dtype (exact as a Python float)
        self.normalizer = float(torch.tensor(cfg.hidden_size ** 0.5, dtype=dtype, device="cpu"))
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", GemmaDecoderLayer(cfg, dtype))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, inputs_embeds: torch.Tensor, bias: torch.Tensor,
                position_ids: torch.Tensor, k_caches: torch.Tensor, v_caches: torch.Tensor,
                cache_index: int) -> torch.Tensor:
        c = self.cfg
        cos, sin = rope_cos_sin(position_ids, c.head_dim, c.rope_theta, self.dtype)
        x = inputs_embeds.to(self.dtype) * self.normalizer
        for i in range(c.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x, bias, cos, sin, k_caches[i], v_caches[i],
                                            cache_index)
        return self.norm(x)


def make_kv_cache(cfg: GemmaTextConfig, batch: int, max_len: int, dtype=torch.float32,
                  device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    device = resolve_device(device, "make_kv_cache")
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
