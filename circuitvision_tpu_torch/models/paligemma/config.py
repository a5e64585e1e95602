"""PaliGemma configuration, the JAX package's `models/paligemma/config.py`
copied: the three dataclasses and `tiny_config()` are its own, field for
field.

Defaults are PaliGemma-3B-pt-224: a SigLIP-So400m vision tower
(27 layers, hidden 1152, patch 14 @ 224²) feeding 256 image tokens into
a Gemma-2B decoder (18 layers, hidden 2048, 8 q heads / 1 kv head —
MQA — head_dim 256).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    num_channels: int = 3

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class GemmaTextConfig:
    hidden_size: int = 2048
    intermediate_size: int = 16384
    num_hidden_layers: int = 18
    num_attention_heads: int = 8
    num_key_value_heads: int = 1
    head_dim: int = 256
    # Published PaliGemma-3B checkpoints: 256000 Gemma pieces + 1024 <loc>
    # + 128 <seg> = 257152 real tokens, <image> appended at 257152, rows
    # padded to 257216. (The transformers CLASS default is 257152 — that
    # is the pre-pad count, not the checkpoint embedding width.)
    vocab_size: int = 257216
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 8192
    # Weight-only int8 for the decoder projections and the (tied)
    # embedding/LM-head: halves the per-step parameter read of a decode
    # step. Build params with quant.quantize_variables.
    quant_int8: bool = False


@dataclasses.dataclass(frozen=True)
class PaliGemmaConfig:
    vision: SiglipVisionConfig = dataclasses.field(default_factory=SiglipVisionConfig)
    text: GemmaTextConfig = dataclasses.field(default_factory=GemmaTextConfig)
    # Vision features are projected to this width and substituted for the
    # image placeholder tokens (must equal text.hidden_size).
    projection_dim: int = 2048
    # <image> id in the published checkpoints' tokenizer (config.json
    # image_token_index). 256000 is the transformers CLASS default and is
    # <loc0000> in the real tokenizer — do not use it with real weights.
    image_token_id: int = 257152
    bos_token_id: int = 2
    eos_token_id: int = 1
    pad_token_id: int = 0

    @property
    def num_image_tokens(self) -> int:
        return self.vision.num_patches


def tiny_config() -> PaliGemmaConfig:
    """Small config for the tests against the JAX package."""
    return PaliGemmaConfig(
        vision=SiglipVisionConfig(
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=2,
            num_attention_heads=2,
            image_size=28,
            patch_size=14,
        ),
        text=GemmaTextConfig(
            hidden_size=48,
            intermediate_size=96,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=1,
            head_dim=16,
            vocab_size=300,
        ),
        projection_dim=48,
        image_token_id=290,
        bos_token_id=2,
        eos_token_id=1,
        pad_token_id=0,
    )
