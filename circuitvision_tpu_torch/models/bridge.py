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
a run that has no checkpoint the machine can read. `flax_names` maps the
other way (the fine-tune's trainable surface is written in flax paths);
`variables_from_state_dict` takes a port state dict back to the JAX
variable tree, exactly (what the checkpoint writer saves), and
`variables_template` gives that tree's paths and shapes from a model on
the meta device (what the converters fill); and `train_state_from_jax`
/ `lora_state_from_jax` carry the JAX package's train state — optax's
Adam and MultiSteps state, the EMA, the LoRA adapters — into the port's,
leaf for leaf.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..core.config import DetectorConfig, SAM2Config, sam2_hiera_preset

_STATS = {"mean": "running_mean", "var": "running_var"}
_STAT_OF = {v: k for k, v in _STATS.items()}


def flatten(tree: Mapping, prefix=()):
    """(path, leaf) of each leaf of nested dicts, the keys as strings."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def port_key(path: tuple[str, ...]) -> str:
    """The port's state-dict key of the JAX variable at `path` ("params" or
    "batch_stats" first)."""
    collection, *mods, leaf_name = path
    if collection == "batch_stats":
        name = _STATS[leaf_name]
    elif leaf_name in ("kernel", "scale"):
        name = "weight"
    else:
        name = leaf_name
    return ".".join(mods + [name])


def port_leaf(path: tuple[str, ...], arr: np.ndarray) -> tuple[str, np.ndarray]:
    """One JAX variable at `path` → the port's (state-dict key, array in
    the port's layout)."""
    mods, leaf_name = path[1:-1], path[-1]
    if leaf_name == "kernel" and arr.ndim == 2:
        arr = arr.T
    elif leaf_name == "kernel" and mods[-1].startswith("output_upscaling"):
        arr = np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))
    elif leaf_name == "kernel":
        arr = np.transpose(arr, (3, 2, 0, 1))
    return port_key(path), arr


def state_dict_from_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX variables {"params": ..., "batch_stats": ...} → port state dict
    (float32 tensors)."""
    out: dict[str, torch.Tensor] = {}
    for path, leaf in flatten(variables):
        key, arr = port_leaf(path, np.asarray(leaf, np.float32))
        if key in out:
            raise KeyError(f"two variables map to {key}")
        out[key] = torch.from_numpy(np.array(arr, np.float32))
    return out


def _norm_modules(model: torch.nn.Module) -> set[str]:
    """Names of the modules whose `weight` is a flax norm's "scale": the
    LayerNorms (float32_params, torch's own, the reader's channel norm)
    and YOLO's BatchNorm."""
    from .layers import FrozenBatchNorm
    from .reader import ChannelLayerNorm

    return {n for n, m in model.named_modules()
            if getattr(m, "float32_params", False)
            or isinstance(m, (torch.nn.LayerNorm, FrozenBatchNorm, ChannelLayerNorm))}


def flax_names(model: torch.nn.Module) -> dict[str, str]:
    """The name map the other way: each parameter of a port model → its
    path in the JAX package's variable tree, "params/<modules>/<leaf>"
    (a Linear or Conv weight is a flax "kernel", a norm's a "scale")."""
    norms = _norm_modules(model)
    out = {}
    for name, _ in model.named_parameters():
        mod, _, leaf = name.rpartition(".")
        if leaf == "weight":
            leaf = "scale" if mod in norms else "kernel"
        out[name] = "/".join(["params", *(mod.split(".") if mod else []), leaf])
    return out


def _jax_path(key: str, names: Mapping[str, str]) -> tuple[str, ...]:
    """The JAX variable path of the port's state-dict `key` (port_key's
    inverse): a parameter by `flax_names`, a BatchNorm statistic in
    "batch_stats"."""
    if key in names:
        return tuple(names[key].split("/"))
    mod, _, leaf = key.rpartition(".")
    stat = _STAT_OF.get(leaf)
    if stat is None:
        raise KeyError(f"{key} is neither a parameter nor a BatchNorm statistic")
    return ("batch_stats", *mod.split("."), stat)


def _jax_layout(path: tuple[str, ...], t: torch.Tensor) -> torch.Tensor:
    """A port tensor in the JAX layout of the variable at `path`
    (port_leaf's inverse; torch ops, so a meta tensor gives the shape)."""
    mods, leaf_name = path[1:-1], path[-1]
    if leaf_name == "kernel" and t.ndim == 2:
        return t.T
    if leaf_name == "kernel" and mods[-1].startswith("output_upscaling"):
        return t.permute(2, 3, 0, 1).flip(0, 1)
    if leaf_name == "kernel":
        return t.permute(2, 3, 1, 0)
    return t


def nest(items) -> dict:
    """Nested dicts of (path, leaf) pairs: `flatten`'s inverse."""
    tree: dict = {}
    for path, leaf in items:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if path[-1] in node:
            raise KeyError(f"two tensors map to {'/'.join(path)}")
        node[path[-1]] = leaf
    return tree


def variables_from_state_dict(state: Mapping[str, torch.Tensor],
                              model: torch.nn.Module) -> dict:
    """The port's state dict of `model` (any device; `model` may lie on
    the meta device) → the JAX variable tree {"params": ...,
    "batch_stats": ...} as nested dicts of float32 numpy arrays: the
    exact inverse of `state_dict_from_variables`."""
    names = flax_names(model)
    items = []
    for key, t in state.items():
        path = _jax_path(key, names)
        arr = _jax_layout(path, t.detach().to("cpu", torch.float32)).contiguous().numpy()
        items.append((path, arr))
    return nest(items)


def variables_template(model: torch.nn.Module) -> dict:
    """The JAX variable tree of `model` as `variables_from_state_dict`
    gives it, each leaf a read-only float32 zero array of the leaf's
    shape that holds no memory (a broadcast scalar): what a converter
    fills, at any size. Build `model` under `torch.device("meta")`."""
    names = flax_names(model)
    zero = np.zeros((), np.float32)
    items = []
    for key, t in model.state_dict().items():
        path = _jax_path(key, names)
        items.append((path, np.broadcast_to(zero, tuple(_jax_layout(path, t).shape))))
    return nest(items)


def as_numpy(v) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    """A numpy leaf as a tensor of the same dtype (bfloat16 arrays, which
    torch.from_numpy does not take, through float32: exact)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr, np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device) if device is not None else t


def _masked(leaf) -> bool:
    """optax's MaskedNode: an empty tuple node where a label's branch does
    not own a leaf."""
    return isinstance(leaf, tuple) and len(leaf) == 0


def _field(node, name: str):
    return node[name] if isinstance(node, Mapping) else getattr(node, name)


def port_tree(tree: Mapping, device=None) -> dict[str, torch.Tensor]:
    """A params-shaped JAX tree (MaskedNode where a leaf is not owned) →
    {port name: tensor in the port's layout}."""
    out = {}
    for path, leaf in flatten(tree):
        if _masked(leaf):
            continue
        key, arr = port_leaf(path, np.asarray(leaf))
        out[key] = tensor_from_numpy(arr, device)
    return out


def _adam_state(chain, to_port, device) -> dict:
    """optax.adam's chain state (ScaleByAdamState, then the schedule's
    state or EmptyState) → the port optimizer's count, mu, nu and, where
    the learning rate is a schedule, schedule_count."""
    adam, sched = chain[0], chain[1]
    state = {"count": torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32),
             "mu": to_port(adam.mu, device), "nu": to_port(adam.nu, device)}
    if "count" in getattr(sched, "_fields", ()):  # ScaleByScheduleState, not EmptyState
        state["schedule_count"] = torch.tensor(int(np.asarray(sched.count)), dtype=torch.int32)
    return state


def _with_accumulation(inner, to_port, device) -> dict:
    """optax.MultiSteps around adam, or adam alone → the port's state."""
    if "mini_step" not in getattr(inner, "_fields", ()):
        return _adam_state(inner, to_port, device)
    state = _adam_state(inner.inner_opt_state, to_port, device)
    state["mini_step"] = torch.tensor(int(np.asarray(inner.mini_step)), dtype=torch.int32)
    state["gradient_step"] = torch.tensor(int(np.asarray(inner.gradient_step)),
                                          dtype=torch.int32)
    state["acc_grads"] = to_port(inner.acc_grads, device)
    return state


def train_state_from_jax(params: Mapping, opt_state, ema=None, trainable=None,
                         device=None) -> tuple[dict, dict, dict | None]:
    """The JAX package's SAM2 train state, as numpy leaves
    (`jax.tree.map(np.asarray, ...)`), → the port's (params, optimizer
    state, EMA):

      * `params`: the variable tree {"params": ...} → {port name: tensor};
      * `opt_state`: make_optimizer's multi_transform state — the "train"
        branch's adam (count, mu, nu, the schedule's count) or its
        MultiSteps (mini_step, gradient_step, acc_grads around the adam
        state) — → train_step.Optimizer's state, moments keyed by port name;
      * `ema`: init_ema's list, in JAX's leaf order of the trainable
        leaves (`trainable`: port names, the optimizer's mask) → {port
        name: tensor}.

    Each leaf keeps its dtype and takes the port's layout."""
    port_params = port_tree(params, device)
    inner = _field(_field(opt_state.inner_states, "train"), "inner_state")
    state = _with_accumulation(inner, port_tree, device)
    if ema is None:
        return port_params, state, None
    return port_params, state, leaves_in_jax_order(params, trainable, ema, device)


def optax_state_from_jax(state, device=None, tree=None):
    """An optax state (numpy leaves) of the transforms in `train/optim.py`
    → the port's state of the same transforms: each optax state
    NamedTuple a dict of its fields (EmptyState {}), a chain's tuple a
    tuple, the moments `mu`/`nu` through `tree` (default `port_tree`: a
    variable tree {"params": ...} → {port name: tensor}), the counters
    and flags tensors of their dtype."""
    tree = tree or port_tree
    if hasattr(state, "_fields"):
        return {f: tree(getattr(state, f), device) if f in ("mu", "nu")
                else optax_state_from_jax(getattr(state, f), device, tree)
                for f in state._fields}
    if isinstance(state, tuple):
        return tuple(optax_state_from_jax(s, device, tree) for s in state)
    return tensor_from_numpy(state, device)


def leaves_in_jax_order(tree: Mapping, names, leaves, device=None) -> dict[str, torch.Tensor]:
    """A list of leaves shaped like the leaves of JAX variable `tree` whose
    port names are in `names`, in JAX's leaf order (dict keys sorted at
    every level; an EMA list, an optimizer's moments) → {port name:
    tensor in the port's layout}."""
    names = set(names)
    paths = [path for path, _ in sorted(flatten(tree), key=lambda item: item[0])
             if port_key(path) in names]
    if len(paths) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for {len(paths)} trainable parameters")
    return {port_key(path): tensor_from_numpy(port_leaf(path, np.asarray(leaf))[1], device)
            for path, leaf in zip(paths, leaves)}


def detector_config(meta: Mapping) -> DetectorConfig:
    """DetectorConfig of a checkpoint's meta.json ("detector" section)."""
    d = meta["detector"]
    return DetectorConfig(scale=d["scale"], img_size=d["img_size"],
                          num_classes=d.get("num_classes", 62), reg_max=d.get("reg_max", 16))


def sam2_config(meta: Mapping, dtype: str | None = None) -> SAM2Config:
    """SAM2Config of a checkpoint's meta.json ("sam2" section: a Hiera
    preset plus overrides). The compute dtype is `dtype` when given, else
    the one the checkpoint was trained in ("sam2_config"/"dtype"), else
    the config's default. A checkpoint without a "sam2" section (a bare
    orbax directory, as `convert_sam2_checkpoint` writes) is the default
    SAM2Config(), as the JAX CLI loads one."""
    dtype = dtype or meta.get("sam2_config", {}).get("dtype")
    extra = {"dtype": dtype} if dtype else {}
    if "sam2" not in meta:
        return SAM2Config(**extra)
    s = meta["sam2"]
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


def _port_tstate(tree: Mapping, device) -> dict[str, torch.Tensor]:
    """A LoRA train-state-shaped JAX tree {"lora": {path: {"a", "b"}},
    "direct": {"params/...": leaf}} → the port's flat names
    ("lora/<path>/a", "lora/<path>/b", "direct/<port name>"); the adapters
    keep the JAX layout, the direct leaves take the port's."""
    out = {}
    for path, ab in tree["lora"].items():
        for part in ("a", "b"):
            out[f"lora/{path}/{part}"] = tensor_from_numpy(ab[part], device)
    for key, leaf in tree["direct"].items():
        name, arr = port_leaf(tuple(key.split("/")), np.asarray(leaf))
        out[f"direct/{name}"] = tensor_from_numpy(arr, device)
    return out


def lora_state_from_jax(tstate: Mapping, opt_state, device=None) -> tuple[dict, dict]:
    """The JAX package's LoRA train state (make_lora_train_step's tstate
    and make_lora_optimizer's adam or MultiSteps state), as numpy leaves,
    → the port's (tstate {"lora": {path: {"a", "b"}}, "direct": {port
    name: tensor}}, optimizer state over train/lora.flat_names)."""
    from ..train.lora import unflatten

    return (unflatten(_port_tstate(tstate, device)),
            _with_accumulation(opt_state, _port_tstate, device))
