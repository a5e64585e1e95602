"""SAM 2.1 fine-tuned checkpoint → the JAX variable tree, with LoRA
folding, without JAX.

Counterpart of the JAX package's `models/sam2/convert.py`: the same name
map, layouts, folding arithmetic (numpy float32), checks and error
messages, over nested dicts of numpy arrays. The tree to fill is
`bridge.variables_template` of a port `SAM2ImageSegmenter` built on the
meta device, so SAM2.1-L costs no memory until its weights arrive.

The reference checkpoint (`best_miou_model_SAM_latest.pth`) is a
PEFT-wrapped SAM2ImageWrapper state dict: keys live under
`sam2_model.base_model.model.*` with `base_layer` / `lora_A.default` /
`lora_B.default` entries on the 36 LoRA target modules, plus the
wrapper's net-new parameters (dense/sparse prompt embeddings, refinement
head). For inference the LoRA deltas fold into the base weights:
    W_eff = W + (alpha / r) · B @ A          (Linear)
    ΔW[o,i,kh,kw] = (alpha/r) Σ_r B[o,r]·A[r,i,kh,kw]   (Conv2d)
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np

from ..bridge import as_numpy, flatten, nest

_LORA_A = re.compile(r"^(.*)\.lora_A\.(?:default\.)?weight$")
_LORA_B = re.compile(r"^(.*)\.lora_B\.(?:default\.)?weight$")

#: The 36 LoRA target modules of the reference fine-tune (base_parts +
#: added_parts). A real fine-tuned checkpoint carries
#: `<target>.base_layer.weight` + `<target>.lora_A/lora_B` entries for
#: exactly these.
REFERENCE_LORA_TARGETS = tuple(
    [
        f"sam_mask_decoder.transformer.layers.{i}.{attn}.{proj}"
        for i in (0, 1)
        for attn in ("self_attn", "cross_attn_token_to_image")
        for proj in ("k_proj", "q_proj", "v_proj", "out_proj")
    ]
    + [
        f"sam_mask_decoder.transformer.layers.{i}.mlp.layers.{j}"
        for i in (0, 1)
        for j in (0, 1)
    ]
    + [
        "sam_mask_decoder.iou_prediction_head.layers.2",
        "sam_mask_decoder.conv_s0",
        "sam_mask_decoder.conv_s1",
        "image_encoder.neck.convs.2.conv",
        "image_encoder.neck.convs.3.conv",
        "image_encoder.trunk.blocks.44.attn.qkv",
        "image_encoder.trunk.blocks.44.mlp.layers.0",
        "image_encoder.trunk.blocks.44.proj",
        "image_encoder.trunk.blocks.47.attn.qkv",
        "image_encoder.trunk.blocks.47.mlp.layers.0",
    ]
    + [
        f"sam_mask_decoder.transformer.layers.{i}.cross_attn_image_to_token.{proj}"
        for i in (0, 1)
        for proj in ("q_proj", "k_proj", "v_proj")
    ]
)

#: Checkpoint entries the image pipeline never consumes: the SAM2
#: video-memory machinery and torch bookkeeping.
KNOWN_UNUSED_PREFIXES = (
    "memory_attention.",
    "memory_encoder.",
    "mask_downsample.",
    "obj_ptr_proj.",
    "obj_ptr_tpos_proj.",
    "no_mem_embed",
    "no_mem_pos_enc",
    "no_obj_ptr",
    "maskmem_tpos_enc",
    "no_obj_embed_spatial",
)
KNOWN_UNUSED_SUFFIXES = (".num_batches_tracked",)


def normalize_and_fold(torch_state: Mapping, lora_alpha: float = 16.0) -> dict[str, np.ndarray]:
    """Strip PEFT prefixes, fold LoRA deltas, return clean torch-name dict."""
    state: dict[str, np.ndarray] = {}
    for k, v in torch_state.items():
        k = k.removeprefix("sam2_model.")
        k = k.replace("base_model.model.", "")
        state[k] = as_numpy(v)

    lora_a: dict[str, np.ndarray] = {}
    lora_b: dict[str, np.ndarray] = {}
    base: dict[str, np.ndarray] = {}
    for k, v in state.items():
        ma, mb = _LORA_A.match(k), _LORA_B.match(k)
        if ma:
            lora_a[ma.group(1)] = v
        elif mb:
            lora_b[mb.group(1)] = v
        else:
            base[k.replace(".base_layer.", ".")] = v

    dangling = set(lora_a) ^ set(lora_b)
    if dangling:
        raise KeyError(f"LoRA A/B pairs incomplete for {sorted(dangling)[:8]} "
                       f"({len(dangling)} modules)")
    for mod, a in lora_a.items():
        b = lora_b[mod]
        r = a.shape[0]
        scale = lora_alpha / r
        wkey = f"{mod}.weight"
        w = base.get(wkey)
        if w is None:
            raise KeyError(f"LoRA target {mod} has no base weight {wkey}")
        if w.ndim == 2:  # Linear (out, in)
            delta = scale * (b @ a)
        elif w.ndim == 4:  # Conv2d (out, in, kh, kw)
            a4 = a if a.ndim == 4 else a.reshape(r, *w.shape[1:])
            b2 = b.reshape(w.shape[0], r)
            delta = scale * np.einsum("or,rikl->oikl", b2, a4)
        else:
            raise ValueError(f"LoRA target {mod} has unsupported ndim {w.ndim}")
        base[wkey] = w + delta.astype(w.dtype)
    return base


_IDX = re.compile(r"^(blocks|layers|convs|conv_branches|output_hypernetworks_mlps|mlp_layers"
                  r"|output_upscaling)_(\d+)(_conv)?$")
_RENAMES = {
    "mlp_lin1": "mlp.layers.0",
    "mlp_lin2": "mlp.layers.1",
    "patch_embed_proj": "patch_embed.proj",
    "trunk": "image_encoder.trunk",
    "neck": "image_encoder.neck",
    "dense_pe": "sam_prompt_encoder.pe_layer",
    "conv_s0": "sam_mask_decoder.conv_s0",
    "conv_s1": "sam_mask_decoder.conv_s1",
}


def _torch_module(name: str) -> str:
    m = _IDX.match(name)
    if m:
        base, idx, conv_suffix = m.group(1), m.group(2), m.group(3)
        base = {"mlp_layers": "mlp.layers"}.get(base, base)
        return f"{base}.{idx}" + (".conv" if conv_suffix else "")
    return _RENAMES.get(name, name)


def _flax_path_to_torch_key(path: tuple[str, ...]) -> tuple[str, str]:
    """Return (torch key, leaf kind). Leaf kinds: conv, convT, norm, raw,
    embed, nchw."""
    *mods, leaf = path
    parts = [_torch_module(m) for m in mods]
    kind, torch_leaf = "raw", leaf
    if leaf == "kernel":
        kind = "convT" if ".".join(parts).endswith(("output_upscaling.0",
                                                    "output_upscaling.3")) else "conv"
        torch_leaf = "weight"
    elif leaf == "scale":
        kind, torch_leaf = "norm", "weight"
    elif leaf in ("iou_token", "mask_tokens", "obj_score_token"):
        parts.append(leaf)
        kind, torch_leaf = "embed", "weight"
    elif leaf in ("pos_embed", "pos_embed_window"):
        parts.append(leaf)
        kind, torch_leaf = "nchw", ""
    elif leaf in ("dense_embedding1", "dense_embedding2", "sparse_embedding",
                  "positional_encoding_gaussian_matrix"):
        parts.append(leaf)
        torch_leaf = ""
    key = ".".join(parts + ([torch_leaf] if torch_leaf else []))
    return key, kind


def _to_flax(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        if arr.ndim == 4:
            return np.transpose(arr, (2, 3, 1, 0))  # OIHW → HWIO
        return arr.T  # dense weight (out, in) → (in, out)
    if kind == "convT":
        # torch ConvTranspose2d (in,out,kh,kw) → flax (kh,kw,in,out) with a
        # spatial flip: flax's ConvTranspose (transpose_kernel=False)
        # correlates with the un-flipped kernel, torch convolves.
        return np.transpose(arr, (2, 3, 0, 1))[::-1, ::-1].copy()
    if kind == "nchw":
        return np.transpose(arr, (0, 2, 3, 1))
    return arr


def _from_flax(arr: np.ndarray, kind: str) -> np.ndarray:
    """Inverse of _to_flax (torch-side layout from a flax leaf)."""
    arr = np.asarray(arr)
    if kind == "conv":
        if arr.ndim == 4:
            return np.transpose(arr, (3, 2, 0, 1))  # HWIO → OIHW
        return arr.T
    if kind == "convT":
        return np.transpose(arr[::-1, ::-1], (2, 3, 0, 1)).copy()
    if kind == "nchw":
        return np.transpose(arr, (0, 3, 1, 2))
    return arr


def export_torch_state(variables: Mapping) -> dict[str, np.ndarray]:
    """The JAX variable tree → torch-named state dict (exact inverse of
    convert_state_dict's name map and layout transposes): a port
    fine-tune in the reference's naming, or a complete reference-shaped
    checkpoint for a test."""
    out: dict[str, np.ndarray] = {}
    for path, leaf_val in sorted(flatten(variables)):
        tkey, kind = _flax_path_to_torch_key(path[1:])
        if tkey in out:
            raise KeyError(f"Name map is not injective: {tkey} from {list(path)}")
        out[tkey] = _from_flax(np.asarray(leaf_val, np.float32), kind)
    return out


def convert_state_dict(torch_state: Mapping, template: Mapping,
                       lora_alpha: float = 16.0) -> dict:
    """Fill the SAM2ImageSegmenter variable tree `template` (paths and
    shapes, e.g. `bridge.variables_template`) from a (possibly PEFT)
    torch state dict, float32.

    Raises KeyError listing any parameter with no source weight, and any
    source weight that no parameter consumed — excluding the video-memory
    machinery (KNOWN_UNUSED_PREFIXES) the image pipeline never runs.
    """
    state = normalize_and_fold(torch_state, lora_alpha=lora_alpha)
    missing, filled = [], []
    used: set[str] = set()
    for path, leaf_val in flatten(template):
        tkey, kind = _flax_path_to_torch_key(path[1:])
        if tkey not in state:
            missing.append(tkey)
            continue
        used.add(tkey)
        arr = _to_flax(state[tkey], kind)
        shape = tuple(leaf_val.shape)
        if arr.shape != shape and arr.size == np.prod(shape):
            arr = arr.reshape(shape)
        if arr.shape != shape:
            raise ValueError(f"Shape mismatch {tkey}: torch→{arr.shape} flax {shape}")
        filled.append((path, np.array(arr, np.float32)))
    if missing:
        raise KeyError(f"Missing {len(missing)} weights, e.g. {sorted(missing)[:8]}")
    extra = [k for k in state
             if k not in used and not k.startswith(KNOWN_UNUSED_PREFIXES)
             and not k.endswith(KNOWN_UNUSED_SUFFIXES)]
    if extra:
        raise KeyError(f"{len(extra)} checkpoint weights were silently dropped, "
                       f"e.g. {sorted(extra)[:8]}")
    return nest(filled)


#: The LoRA rank of the reference fine-tune.
REFERENCE_LORA_RANK = 4


def reference_checkpoint_inventory(variables: Mapping) -> dict[str, tuple]:
    """The complete key → shape inventory of the reference's fine-tuned
    checkpoint as PEFT + SAM2ImageWrapper write it:

      - SAM2 internals under ``sam2_model.base_model.model.*``;
      - the LoRA targets carry ``.base_layer.weight`` (and
        ``.base_layer.bias`` where the module has one) plus
        ``lora_A.default.weight`` / ``lora_B.default.weight`` in PEFT's
        Linear/Conv2d adapter layouts;
      - wrapper net-new params (prompt embeddings, refinement head) at
        top level, un-prefixed.

    Frozen in tests/fixtures/sam2_l_reference_checkpoint_keys.json.
    `variables` may be a `bridge.variables_template`. Video-memory keys
    (KNOWN_UNUSED_PREFIXES) are part of real checkpoints but unknown to
    this image-only model.
    """
    rank = REFERENCE_LORA_RANK
    torch_state = export_torch_state(variables)
    model_roots = ("image_encoder.", "sam_mask_decoder.", "sam_prompt_encoder.")
    inv: dict[str, tuple] = {}
    for key, val in torch_state.items():
        shape = tuple(int(s) for s in np.shape(val))
        if not key.startswith(model_roots):
            inv[key] = shape  # wrapper net-new params stay bare
            continue
        mod, leaf = key.rsplit(".", 1)
        base = f"sam2_model.base_model.model.{mod}"
        if mod in REFERENCE_LORA_TARGETS and leaf in ("weight", "bias"):
            # PEFT moves the whole base module under .base_layer
            inv[f"{base}.base_layer.{leaf}"] = shape
            if leaf == "weight":
                if len(shape) == 2:  # Linear (out, in)
                    inv[f"{base}.lora_A.default.weight"] = (rank, shape[1])
                    inv[f"{base}.lora_B.default.weight"] = (shape[0], rank)
                else:  # Conv2d (out, in, kh, kw): A is a conv, B is 1×1
                    inv[f"{base}.lora_A.default.weight"] = (rank, *shape[1:])
                    inv[f"{base}.lora_B.default.weight"] = (shape[0], rank, 1, 1)
        else:
            inv[f"sam2_model.base_model.model.{key}"] = shape
    return inv


def expected_torch_keys(variables: Mapping) -> set[str]:
    return {_flax_path_to_torch_key(path[1:])[0] for path, _ in flatten(variables)}
