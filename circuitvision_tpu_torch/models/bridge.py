"""Weights for the port's models: from the JAX package's variables, or
made from a seed.

`state_dict_from_variables` takes a YOLO or SAM2 variable tree of the
JAX package as nested dicts of numpy arrays (what
`jax.tree.map(np.asarray, load_variables(...))` gives) and returns the
port's state dict. The port's modules carry the JAX tree's names, so the
map is by name; only layouts change:

  * Dense kernel (in, out) → Linear weight (out, in);
  * Conv kernel HWIO → Conv2d weight OIHW;
  * ConvTranspose kernel (kh, kw, in, out) → ConvTranspose2d weight
    (in, out, kh, kw), spatially flipped (flax's transposed conv
    correlates with the un-flipped kernel, torch's convolves);
  * LayerNorm / BatchNorm scale → weight, batch_stats mean/var →
    running_mean/running_var.

Loading the result with `strict=True` checks that every name and shape
lines up. `seeded_state` builds full-shape weights from a numpy seed for
a run that has no checkpoint the machine can read.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..core.config import DetectorConfig, SAM2Config, sam2_hiera_preset

_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def state_dict_from_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX variables {"params": ..., "batch_stats": ...} → port state dict
    (float32 tensors)."""
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(variables):
        collection, *mods, leaf_name = path
        arr = np.asarray(leaf, np.float32)
        if collection == "batch_stats":
            name = _STATS[leaf_name]
        elif leaf_name in ("kernel", "scale"):
            name = "weight"
        else:
            name = leaf_name
        if leaf_name == "kernel" and arr.ndim == 2:
            arr = arr.T
        elif leaf_name == "kernel" and mods[-1].startswith("output_upscaling"):
            arr = np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))
        elif leaf_name == "kernel":
            arr = np.transpose(arr, (3, 2, 0, 1))
        key = ".".join(mods + [name])
        if key in out:
            raise KeyError(f"two variables map to {key}")
        out[key] = torch.from_numpy(np.array(arr, np.float32))
    return out


def detector_config(meta: Mapping) -> DetectorConfig:
    """DetectorConfig of a checkpoint's meta.json ("detector" section)."""
    d = meta["detector"]
    return DetectorConfig(scale=d["scale"], img_size=d["img_size"],
                          num_classes=d.get("num_classes", 62), reg_max=d.get("reg_max", 16))


def sam2_config(meta: Mapping, dtype: str | None = None) -> SAM2Config:
    """SAM2Config of a checkpoint's meta.json ("sam2" section: a Hiera
    preset plus overrides). The compute dtype is `dtype` when given, else
    the one the checkpoint was trained in ("sam2_config"/"dtype"), else
    the config's default."""
    s = meta["sam2"]
    dtype = dtype or meta.get("sam2_config", {}).get("dtype")
    extra = {"dtype": dtype} if dtype else {}
    return sam2_hiera_preset(s["preset"], **{**s.get("overrides", {}), **extra})


def seeded_state(kind: str, meta: Mapping, seed: int) -> dict[str, torch.Tensor]:
    """Full-shape float32 weights for `kind` ("yolo" or "sam2") at the
    shapes a checkpoint's meta.json names, drawn from
    numpy.random.default_rng(seed): He-scaled normals for matrices and
    kernels, small normals for other vectors, zero biases, unit norm
    scales. The detector's BatchNorm statistics are then calibrated on
    one seeded noise image (each layer's running mean and variance set
    to its input's), so activations keep unit scale through the network
    and the head's scores spread instead of all sitting at 0.5."""
    from .sam2.wrapper import SAM2ImageSegmenter
    from .yolo.model import YOLOv11

    if kind == "yolo":
        cfg = detector_config(meta)
        model = YOLOv11(cfg.num_classes, cfg.scale, cfg.reg_max)
    elif kind == "sam2":
        model = SAM2ImageSegmenter(sam2_config(meta))
    else:
        raise ValueError(f"unknown model kind {kind!r}")
    norms = {n for n, m in model.named_modules()
             if type(m).__name__ in ("LayerNorm", "TrunkLayerNorm", "FrozenBatchNorm")}
    gen = np.random.default_rng(seed)
    state = {}
    for key, t in model.state_dict().items():
        mod, _, leaf = key.rpartition(".")
        shape = tuple(t.shape)
        if leaf in ("bias", "running_mean"):
            arr = np.zeros(shape, np.float32)
        elif leaf == "running_var" or (leaf == "weight" and mod in norms):
            arr = np.ones(shape, np.float32)
        elif len(shape) >= 2:
            arr = gen.normal(0.0, (2.0 / np.prod(shape[1:])) ** 0.5, size=shape)
        else:
            arr = gen.normal(0.0, 0.02, size=shape)
        state[key] = torch.from_numpy(np.asarray(arr, np.float32))
    if kind == "yolo":
        model.load_state_dict(state)
        _calibrate_batchnorm(model, gen, cfg.img_size)
        state = {k: v.clone() for k, v in model.state_dict().items()}
    return state


def _calibrate_batchnorm(model: torch.nn.Module, gen, img_size: int) -> None:
    """Set every FrozenBatchNorm's statistics to those of its input on
    one noise image, layer after layer in forward order."""
    from .layers import FrozenBatchNorm

    def hook(bn, args):
        x = args[0]
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(x.var(dim=(0, 2, 3)))

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, FrozenBatchNorm)]
    x = torch.from_numpy(gen.random((1, img_size, img_size, 3), dtype=np.float32))
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
