"""HF PaliGemma checkpoint → the JAX package's PaliGemma variable tree:
its `models/paligemma/convert.py` with torch and numpy only.

Accepts the torch state_dict key layout of
PaliGemmaForConditionalGeneration, both the current nested form
("model.vision_tower…", "model.language_model…", "lm_head.weight") and
the pre-4.52 flat form ("vision_tower…", "language_model.model…",
"language_model.lm_head.weight").

Conversion is no-silent-drop in BOTH directions: every checkpoint tensor
must be consumed (lm_head is verified against the tied embedding, not
dropped) and every produced leaf must land on a declared parameter of
the model at `cfg` (`_validate_shapes`, against the port model's own
shapes where the JAX package asks jax.eval_shape; the messages are its
own, word for word). `model.from_variables` builds the port's model from
the result; the orbax writer saves it as the JAX package does.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import PaliGemmaConfig
from ..bridge import flatten, nest
from .model import PaliGemma, jax_leaf


def torch_state_to_numpy(state_dict) -> dict[str, np.ndarray]:
    return {k: np.asarray(v.detach().cpu().numpy()) for k, v in state_dict.items()}


def _canon(key: str) -> str:
    """Normalize both HF layouts to one canonical spelling."""
    if key.startswith("model."):
        key = key[len("model."):]
    key = key.replace("language_model.model.", "language_model.")
    if key == "language_model.lm_head.weight":
        key = "lm_head.weight"
    return key


def convert_hf_state(state: Mapping[str, np.ndarray], cfg: PaliGemmaConfig) -> dict:
    """torch state_dict (tensors or arrays) → {"params": ...} for PaliGemma."""
    src: dict[str, np.ndarray] = {}
    for k, v in state.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        src[_canon(k)] = np.asarray(v)
    used: set[str] = set()

    def take(key: str) -> np.ndarray:
        if key not in src:
            raise KeyError(f"checkpoint is missing {key!r}")
        used.add(key)
        return src[key]

    def linear(prefix: str, bias: bool = True) -> dict:
        out = {"kernel": take(f"{prefix}.weight").T}
        if bias:
            out["bias"] = take(f"{prefix}.bias")
        return out

    def layernorm(prefix: str) -> dict:
        return {"scale": take(f"{prefix}.weight"), "bias": take(f"{prefix}.bias")}

    vt = "vision_tower.vision_model"
    vision: dict = {
        "patch_embedding": {
            # torch conv (O, I, kh, kw) → flax (kh, kw, I, O)
            "kernel": take(f"{vt}.embeddings.patch_embedding.weight").transpose(2, 3, 1, 0),
            "bias": take(f"{vt}.embeddings.patch_embedding.bias"),
        },
        "position_embedding": take(f"{vt}.embeddings.position_embedding.weight"),
        "post_layernorm": layernorm(f"{vt}.post_layernorm"),
    }
    for i in range(cfg.vision.num_hidden_layers):
        lp = f"{vt}.encoder.layers.{i}"
        vision[f"layer_{i}"] = {
            "layer_norm1": layernorm(f"{lp}.layer_norm1"),
            "layer_norm2": layernorm(f"{lp}.layer_norm2"),
            "self_attn": {
                name: linear(f"{lp}.self_attn.{name}")
                for name in ("q_proj", "k_proj", "v_proj", "out_proj")
            },
            "fc1": linear(f"{lp}.mlp.fc1"),
            "fc2": linear(f"{lp}.mlp.fc2"),
        }

    lm = "language_model"
    embed = take(f"{lm}.embed_tokens.weight")
    decoder: dict = {"norm": {"weight": take(f"{lm}.norm.weight")}}
    for i in range(cfg.text.num_hidden_layers):
        lp = f"{lm}.layers.{i}"
        decoder[f"layer_{i}"] = {
            "input_layernorm": {"weight": take(f"{lp}.input_layernorm.weight")},
            "post_attention_layernorm": {
                "weight": take(f"{lp}.post_attention_layernorm.weight")
            },
            "self_attn": {
                name: linear(f"{lp}.self_attn.{name}", bias=False)
                for name in ("q_proj", "k_proj", "v_proj", "o_proj")
            },
            "gate_proj": linear(f"{lp}.mlp.gate_proj", bias=False),
            "up_proj": linear(f"{lp}.mlp.up_proj", bias=False),
            "down_proj": linear(f"{lp}.mlp.down_proj", bias=False),
        }

    params = {
        "vision_tower": vision,
        "projector": linear("multi_modal_projector.linear"),
        "embed_tokens": {"embedding": embed},
        "decoder": decoder,
    }

    # The LM head is weight-tied; verify rather than drop silently.
    if "lm_head.weight" in src:
        head = take("lm_head.weight")
        if head.shape != embed.shape or not np.array_equal(head, embed):
            raise ValueError(
                "lm_head.weight is not tied to embed_tokens.weight; this "
                "converter only supports tied-embedding checkpoints"
            )
    leftovers = set(src) - used
    if leftovers:
        raise ValueError(f"unconsumed checkpoint tensors: {sorted(leftovers)[:8]}")
    variables = {"params": params}
    _validate_shapes(variables, cfg)
    return variables


def _keystr(path: tuple) -> str:
    """jax.tree_util.keystr of a path of dict keys."""
    return "".join(f"[{k!r}]" for k in path)


def _validate_shapes(variables: dict, cfg: PaliGemmaConfig) -> None:
    """Every produced leaf must match the model's declared parameter
    shapes for this cfg (the port model on the meta device — no memory,
    no compute). Catches e.g. a real 257216-row embedding converted under
    a cfg claiming a different vocab, or a mismatched intermediate width:
    those would otherwise save fine and only fail at load."""
    with torch.device("meta"):
        model = PaliGemma(cfg)
    expected = nest(jax_leaf(k, t) for k, t in model.state_dict().items())
    # in jax's tree order: keys sorted at every level
    want = sorted(flatten(expected), key=lambda kv: kv[0])
    got = {_keystr(k): tuple(np.shape(v))
           for k, v in sorted(flatten(variables), key=lambda kv: kv[0])}
    errors = []
    for key, leaf in want:
        ks = _keystr(key)
        shape = tuple(leaf.shape)
        if ks not in got:
            errors.append(f"missing parameter {ks} {shape}")
        else:
            shp = got.pop(ks)
            if shp != shape:
                errors.append(f"{ks}: checkpoint {shp} vs model {shape}")
    errors += [f"extra leaf {ks} {shp}" for ks, shp in got.items()]
    if errors:
        raise ValueError(
            "converted tree does not match the model's declared parameters: "
            + "; ".join(errors[:6])
        )
