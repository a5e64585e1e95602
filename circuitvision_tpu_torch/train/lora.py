"""Rank-r LoRA adapter fine-tuning on the reference's exact target surface —
the JAX package's `train/lora.py` in PyTorch.

The reference fine-tunes SAM2 through PEFT LoRA adapters — rank 4,
alpha 16 on 36 named modules (src/circuit_analyzer.py:156-212,
src/sam2_infer.py:346-372) — plus the wrapper's net-new parameters
(prompt embeddings, refinement head), which PEFT leaves fully trainable.

  * Adapters are factored ``delta = (alpha/r) * A @ B`` pairs stored
    OUTSIDE the model, keyed by the JAX package's kernel paths
    (`reference_lora_paths`) and in its layout — A (in, r) or (kh, kw, in,
    r), B (r, out) — so the trained artifact carries across unchanged;
    optimizer moments exist only for the adapters and the direct leaves.
  * ``merge_lora`` applies the deltas inside the step, before
    torch.func.functional_call, so the model code is untouched and the
    gradients w.r.t. A and B through the merged weight are PEFT's.
  * ``fold_lora`` materializes serving weights; ``export_peft_state``
    writes the adapters in the reference's `<target>.lora_A.default.weight`
    / `.lora_B.default.weight` names and shapes.

Deliberate deviation (as in the JAX package): PEFT's dropout 0.3 on the
activations entering lora_A cannot be expressed by a weight-space merge,
so these adapters train without it. Initialization is PEFT's: A uniform in
±1/sqrt(fan_in) (kaiming_uniform with a = sqrt(5)), drawn from an explicit
torch.Generator, and B = 0 — step 0 reproduces the base model bitwise.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from ..core.config import TrainConfig
from ..models.bridge import flax_names
from .train_step import (
    TRAINABLE_PATTERNS, Optimizer, apply_updates, check_flash_widths, model_loss,
    trainable_mask,
)

#: wrapper net-new parameters PEFT keeps fully trainable alongside the
#: adapters (modules_to_save analog; src/sam2_infer.py:206-218)
DIRECT_PATTERNS = (
    r"dense_embedding1",
    r"dense_embedding2",
    r"sparse_embedding",
    r"refinement_layer/",
)


def reference_lora_paths(n_trunk_blocks: int = 48) -> tuple[str, ...]:
    """The 36 LoRA target modules as flax kernel-parent paths; the
    reference's trunk blocks 44/47 are (n-4, n-1) of Hiera-L's 48."""
    paths: list[str] = []
    for i in (0, 1):
        for attn in ("self_attn", "cross_attn_token_to_image"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                paths.append(f"sam_mask_decoder/transformer/layers_{i}/{attn}/{proj}")
        for proj in ("q_proj", "k_proj", "v_proj"):
            paths.append(f"sam_mask_decoder/transformer/layers_{i}/"
                         f"cross_attn_image_to_token/{proj}")
        paths.append(f"sam_mask_decoder/transformer/layers_{i}/mlp_lin1")
        paths.append(f"sam_mask_decoder/transformer/layers_{i}/mlp_lin2")
    paths += [
        "sam_mask_decoder/iou_prediction_head/layers_2",
        "conv_s0",
        "conv_s1",
        "neck/convs_2_conv",
        "neck/convs_3_conv",
    ]
    b1, b2 = max(n_trunk_blocks - 4, 0), max(n_trunk_blocks - 1, 0)
    paths += [
        f"trunk/blocks_{b1}/attn/qkv",
        f"trunk/blocks_{b1}/mlp_layers_0",
        f"trunk/blocks_{b1}/proj",
        f"trunk/blocks_{b2}/attn/qkv",
        f"trunk/blocks_{b2}/mlp_layers_0",
    ]
    return tuple(paths)


def _kernel_index(model: torch.nn.Module) -> dict[str, str]:
    """{'a/b/c' (flax kernel parent): port weight name} for every kernel."""
    out = {}
    for name, path in flax_names(model).items():
        parts = path.split("/")
        if parts[-1] == "kernel":
            out["/".join(parts[1:-1])] = name
    return out


def lora_target_paths(model: torch.nn.Module, n_trunk_blocks: int) -> list[str]:
    """Reference targets present in this model (a transition-free trunk
    block has no `proj`; small test configs drop it)."""
    index = _kernel_index(model)
    return [p for p in reference_lora_paths(n_trunk_blocks) if p in index]


def _flax_shape(weight: torch.Tensor) -> tuple[int, ...]:
    """A port weight's shape in flax layout: Linear (out, in) → (in, out),
    Conv2d (out, in, kh, kw) → (kh, kw, in, out)."""
    if weight.dim() == 2:
        return (weight.shape[1], weight.shape[0])
    o, i, kh, kw = weight.shape
    return (kh, kw, i, o)


def init_lora(model: torch.nn.Module, generator: torch.Generator,
              cfg: TrainConfig | None = None, n_trunk_blocks: int = 48,
              targets: list[str] | None = None) -> dict:
    """{'<path>': {'a': (.., in, r), 'b': (r, out)}} adapters, PEFT init,
    float32 on the CPU (the generator's device)."""
    cfg = cfg or TrainConfig()
    r = cfg.lora_rank
    params = dict(model.named_parameters())
    index = _kernel_index(model)
    targets = list(targets) if targets is not None else lora_target_paths(model, n_trunk_blocks)
    lora = {}
    for path in targets:
        shape = _flax_shape(params[index[path]])
        bound = 1.0 / np.sqrt(int(np.prod(shape[:-1])))
        a = (torch.rand((*shape[:-1], r), generator=generator, dtype=torch.float32) * 2 - 1)
        lora[path] = {"a": a * bound, "b": torch.zeros((r, shape[-1]), dtype=torch.float32)}
    return lora


def _delta(ab: Mapping[str, torch.Tensor], alpha: float, weight: torch.Tensor) -> torch.Tensor:
    """(alpha/r)·A@B in float32, in the port layout of `weight`."""
    a, b = ab["a"], ab["b"]
    d = (alpha / b.shape[0]) * torch.einsum("...r,ro->...o", a, b)
    return d.t() if d.dim() == 2 else d.permute(3, 2, 0, 1)


def merge_lora(params: Mapping[str, torch.Tensor], lora: Mapping, index: Mapping[str, str],
               cfg: TrainConfig | None = None) -> dict[str, torch.Tensor]:
    """Functional fold: weights += (alpha/r) A@B in float32, rounded back
    to each weight's dtype; `index` is _kernel_index(model)."""
    cfg = cfg or TrainConfig()
    out = dict(params)
    for path, ab in lora.items():
        name = index[path]
        w = out[name]
        out[name] = (w.float() + _delta(ab, cfg.lora_alpha, w)).to(w.dtype)
    return out


def fold_lora(model: torch.nn.Module, params: Mapping[str, torch.Tensor], lora: Mapping,
              cfg: TrainConfig | None = None) -> dict[str, torch.Tensor]:
    """Materialized serving weights (merge_lora, without a graph)."""
    with torch.no_grad():
        return merge_lora(params, lora, _kernel_index(model), cfg)


def _torch_key(path: str) -> str:
    """The reference's module name of a flax kernel path (the JAX
    package's models/sam2/convert._flax_path_to_torch_key, for the module
    names the adapters reach)."""
    parts = []
    for name in path.split("/"):
        m = re.match(r"^(blocks|layers|convs|conv_branches|output_hypernetworks_mlps|mlp_layers"
                     r"|output_upscaling)_(\d+)(_conv)?$", name)
        if m:
            base = {"mlp_layers": "mlp.layers"}.get(m.group(1), m.group(1))
            parts.append(f"{base}.{m.group(2)}" + (".conv" if m.group(3) else ""))
        elif name in ("mlp_lin1", "mlp_lin2"):
            parts.append(f"mlp.layers.{int(name[-1]) - 1}")
        elif name in ("trunk", "neck"):
            parts.append(f"image_encoder.{name}")
        elif name in ("conv_s0", "conv_s1"):
            parts.append(f"sam_mask_decoder.{name}")
        else:
            parts.append(name)
    return ".".join(parts)


def export_peft_state(lora: Mapping) -> dict[str, np.ndarray]:
    """Adapters in the reference checkpoint's PEFT naming/layout:
    `<torch target>.lora_A.default.weight` (r, in[, kh, kw]) and
    `.lora_B.default.weight` (out, r[, 1, 1])."""
    out: dict[str, np.ndarray] = {}
    for path, ab in lora.items():
        mod = _torch_key(path)
        a = ab["a"].detach().float().cpu().numpy()
        b = ab["b"].detach().float().cpu().numpy()
        if a.ndim == 2:  # dense: flax (in, r) → torch (r, in)
            out[f"{mod}.lora_A.default.weight"] = a.T
            out[f"{mod}.lora_B.default.weight"] = b.T
        else:  # conv: flax (kh, kw, in, r) → torch (r, in, kh, kw)
            out[f"{mod}.lora_A.default.weight"] = np.transpose(a, (3, 2, 0, 1))
            out[f"{mod}.lora_B.default.weight"] = b.T[..., None, None]
    return out


# ------------------------------------------------------------------ training
def direct_mask(model: torch.nn.Module) -> dict[str, bool]:
    """{port name: True for the wrapper's net-new (fully trained)
    parameters} — DIRECT_PATTERNS, a subset of train_step's surface."""
    assert all(any(re.search(d, t) for t in TRAINABLE_PATTERNS) for d in DIRECT_PATTERNS)
    return trainable_mask(model, DIRECT_PATTERNS)


def flat_names(tstate: Mapping) -> dict[str, torch.Tensor]:
    """The train state as one flat dict, the optimizer's leaves:
    "lora/<path>/a", "lora/<path>/b", "direct/<port name>"."""
    out = {f"lora/{p}/{k}": ab[k] for p, ab in tstate["lora"].items() for k in ("a", "b")}
    out.update({f"direct/{n}": t for n, t in tstate["direct"].items()})
    return out


def unflatten(flat: Mapping[str, torch.Tensor]) -> dict:
    """flat_names' inverse."""
    tstate = {"lora": {}, "direct": {}}
    for name, t in flat.items():
        kind, _, rest = name.partition("/")
        if kind == "lora":
            path, _, part = rest.rpartition("/")
            tstate["lora"].setdefault(path, {})[part] = t
        else:
            tstate["direct"][rest] = t
    return tstate


def make_lora_optimizer(cfg: TrainConfig | None = None) -> Optimizer:
    """Adam over the (lora, direct) train state — everything in it trains,
    so no freeze routing and no moment buffers for the base model."""
    return Optimizer(cfg or TrainConfig())


def _lora_trunk_cutoff(lora: Mapping) -> int:
    """Earliest trunk block carrying an adapter — the kernel boundary
    (hiera.force_fused): blocks before it keep the forward kernels."""
    cutoff = 1 << 30
    for path in lora:
        hit = re.match(r"trunk/blocks_(\d+)/", path)
        if hit:
            cutoff = min(cutoff, int(hit.group(1)))
    return cutoff


def lora_loss_and_grads(model, base: Mapping[str, torch.Tensor], tstate: Mapping, images,
                        masks, cfg: TrainConfig | None = None):
    """(loss, metrics, grads over flat_names(tstate)): the base weights
    enter without grad, the direct leaves replace theirs, the adapters are
    merged into their weights, and the trunk before the earliest adapter
    keeps its kernels."""
    from ..models.sam2 import hiera

    cfg = cfg or TrainConfig()
    flat = {n: t.detach().requires_grad_() for n, t in flat_names(tstate).items()}
    ts = unflatten(flat)
    params = {n: p.detach() for n, p in base.items()}
    params.update(ts["direct"])
    params = merge_lora(params, ts["lora"], _kernel_index(model), cfg)
    with hiera.force_fused(_lora_trunk_cutoff(ts["lora"])):
        loss, metrics = model_loss(model, params, images, masks, cfg)
        got = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    grads = {n: g if g is not None else torch.zeros_like(flat[n]) for n, g in zip(flat, got)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_lora_train_step(model: torch.nn.Module, tx: Optimizer, cfg: TrainConfig | None = None):
    """Returns train_step(base, tstate, opt_state, images, masks) →
    (tstate, opt_state, metrics). `base` ({port name: tensor}) is never
    updated and never in the optimizer; tstate = {"lora": init_lora(...),
    "direct": {port name: leaf}} holds everything that trains. Serve with
    `materialize(model, base, tstate)`. A model on the card whose blocks
    from the earliest adapted one on FlashAttention's kernels cannot take
    raises KernelError before the step runs (`check_flash_widths`)."""
    cfg = cfg or TrainConfig()

    def train_step(base, tstate, opt_state, images, masks):
        check_flash_widths(model, _lora_trunk_cutoff(tstate["lora"]))
        _loss, metrics, grads = lora_loss_and_grads(model, base, tstate, images, masks, cfg)
        updates, opt_state = tx.update(grads, opt_state)
        return unflatten(apply_updates(flat_names(tstate), updates)), opt_state, metrics

    return train_step


def init_train_state(model: torch.nn.Module, generator: torch.Generator,
                     cfg: TrainConfig | None = None, n_trunk_blocks: int = 48) -> dict:
    """{"lora": adapters, "direct": {port name: leaf}} for
    make_lora_train_step; the adapters on the model's device."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    lora = init_lora(model, generator, cfg, n_trunk_blocks)
    direct = {n: params[n].detach().clone() for n, m in direct_mask(model).items() if m}
    return {"lora": {p: {k: t.to(dev) for k, t in ab.items()} for p, ab in lora.items()},
            "direct": direct}


def materialize(model: torch.nn.Module, base: Mapping[str, torch.Tensor], tstate: Mapping,
                cfg: TrainConfig | None = None) -> dict[str, torch.Tensor]:
    """Base weights + trained state → serving weights (direct leaves
    written back, adapters folded)."""
    params = dict(base)
    params.update(tstate["direct"])
    return fold_lora(model, params, tstate["lora"], cfg)
