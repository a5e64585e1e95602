"""SigLIP vision tower (PaliGemma's image encoder): the JAX package's
`models/paligemma/vision.py` in torch.

A valid-padded patch conv, learned position embeddings, pre-LN blocks
with biased q/k/v/out projections and tanh-GELU MLPs, and a final post
layernorm; no CLS token, every patch token is emitted. The JAX tower is
plain Flax (dense products at static shapes, no Pallas kernel), so this
is plain torch, with flax's numerics:

  * LayerNorm is flax's (`models.layers.LayerNorm`): float32 statistics
    in the fast-variance form E[x²] − mean², eps 1e-6, scale and bias in
    float32, one rounding to the input dtype;
  * GELU is the tanh form;
  * attention logits are taken in the compute dtype and then scaled by
    hd**-0.5; the softmax runs in float32 and is cast back before the
    product with V.

Module names are the JAX tree's (`layer_0`, `self_attn.q_proj`, ...), so
`model.state_dict_from_variables` maps the trees by name.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import LayerNorm
from .config import SiglipVisionConfig


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu(approximate=True); HF ACT2FN["gelu_pytorch_tanh"]
    return F.gelu(x, approximate="tanh")


class VisionAttention(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        c = cfg.hidden_size
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, nn.Linear(c, c, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, s, _ = x.shape
        h, hd = c.num_attention_heads, c.head_dim
        q = self.q_proj(x).view(b, s, h, hd)
        k = self.k_proj(x).view(b, s, h, hd)
        v = self.v_proj(x).view(b, s, h, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (hd ** -0.5)
        w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, c.hidden_size)
        return self.out_proj(out)


class VisionBlock(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, dtype: torch.dtype):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = VisionAttention(cfg, dtype)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, dtype=dtype)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.fc2(gelu_tanh(self.fc1(self.layer_norm2(x))))


class SiglipVisionTower(nn.Module):
    """pixel_values (B, H, W, 3), SigLIP-normalized → (B, P, hidden)."""

    def __init__(self, cfg: SiglipVisionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        p = cfg.patch_size
        self.patch_embedding = nn.Conv2d(cfg.num_channels, cfg.hidden_size, p, stride=p,
                                         dtype=dtype)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.num_patches, cfg.hidden_size, dtype=dtype))
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", VisionBlock(cfg, dtype))
        self.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = self.patch_embedding(pixel_values.to(self.dtype).permute(0, 3, 1, 2))
        # (B, C, H', W') → (B, H'·W', C): the row-major patch order of
        # flax's NHWC reshape
        x = x.flatten(2).transpose(1, 2)
        x = x + self.position_embedding.to(x.dtype)[None]
        for i in range(c.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x)
        return self.post_layernorm(x)
