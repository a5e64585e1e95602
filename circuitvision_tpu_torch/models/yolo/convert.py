"""Ultralytics YOLOv11 checkpoint → the JAX variable tree, without JAX.

Counterpart of the JAX package's `models/yolo/convert.py`: the same name
map, layouts, checks and error messages, over nested dicts of numpy
arrays. The tree to fill is `bridge.variables_template` of a port
`YOLOv11` built on the meta device (no flax `init`), so any scale costs
no memory until its weights arrive; `bridge.state_dict_from_variables`
takes the result to the port's modules, `checkpoint_writer.save_variables`
to an orbax checkpoint.

Name translation (torch → flax):
  model.{i}.*            → b{i} / h{i} top-level module (see _TOP_MAP)
  m.{j}                  → m_{j}
  ffn.{j}                → ffn_{j}
  cv2.{i}.{j} (detect)   → cv2_{i}_{j}
  cv3.{i}.{a}.{b}        → cv3_{i}_{a}_{b}
  conv.weight            → conv/kernel  (OIHW → HWIO)
  bn.{weight,bias}       → bn/{scale,bias}
  bn.running_{mean,var}  → bn/{mean,var}      (batch_stats collection)
  weight,bias (bare conv)→ kernel,bias        (detect output convs)

The DFL layer (model.23.dfl.conv.weight, a frozen arange) has no
counterpart: the decode computes the softmax expectation directly.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np

from ..bridge import as_numpy, flatten, nest

_TOP_MAP = {
    "b0": "model.0", "b1": "model.1", "b2": "model.2", "b3": "model.3",
    "b4": "model.4", "b5": "model.5", "b6": "model.6", "b7": "model.7",
    "b8": "model.8", "b9": "model.9", "b10": "model.10",
    "h13": "model.13", "h16": "model.16", "h17": "model.17",
    "h19": "model.19", "h20": "model.20", "h22": "model.22",
}

_DETECT_RE2 = re.compile(r"^cv2_(\d+)_(\d+)$")
_DETECT_RE3 = re.compile(r"^cv3_(\d+)_(\d+)_(\d+)$")
_DETECT_RE3_FINAL = re.compile(r"^cv3_(\d+)_2$")
_SUB_RE = re.compile(r"^(m|ffn)_(\d+)$")
_LEAF_MAP = {
    ("conv", "kernel"): "conv.weight",
    ("bn", "scale"): "bn.weight",
    ("bn", "bias"): "bn.bias",
    ("bn", "mean"): "bn.running_mean",
    ("bn", "var"): "bn.running_var",
}


def _detect_module(p: str) -> str | None:
    """The torch module of a detect-head flax module name, or None."""
    m3f, m3, m2 = _DETECT_RE3_FINAL.match(p), _DETECT_RE3.match(p), _DETECT_RE2.match(p)
    if m3f:
        return f"model.23.cv3.{m3f.group(1)}.2"
    if m3:
        return f"model.23.cv3.{m3.group(1)}.{m3.group(2)}.{m3.group(3)}"
    if m2:
        return f"model.23.cv2.{m2.group(1)}.{m2.group(2)}"
    return None


def _sub(p: str) -> str:
    sub = _SUB_RE.match(p)
    return f"{sub.group(1)}.{sub.group(2)}" if sub else p


def _flax_path_to_torch_key(path: tuple[str, ...]) -> str:
    """Translate a flax variable path (without collection) to a torch key."""
    parts: list[str] = []
    for i, p in enumerate(path[:-2] if len(path) >= 2 else path):
        if i == 0:
            top = _TOP_MAP.get(p) or _detect_module(p)
            if top is None:
                raise KeyError(f"Unknown top-level module {p!r} in path {path}")
            parts.append(top)
        else:
            parts.append(_sub(p))

    mod, leaf = path[-2], path[-1]
    mod_t = _sub(mod)
    if not parts:
        # Top-level leaf module (the detect head's final 1×1 convs).
        mod_t = _detect_module(mod) or mod_t
    if (mod, leaf) in _LEAF_MAP:
        suffix = _LEAF_MAP[(mod, leaf)]
        return ".".join(parts + [suffix]) if parts else suffix
    # Bare final conv of the detect head: path like ('cv2_0_2', 'kernel').
    if leaf == "kernel":
        return ".".join(parts + [mod_t, "weight"])
    if leaf == "bias":
        return ".".join(parts + [mod_t, "bias"])
    raise KeyError(f"Unmapped leaf {path}")


#: Checkpoint entries with no counterpart by design: the frozen DFL
#: arange conv (the decode computes the expectation directly) and torch
#: BatchNorm bookkeeping.
KNOWN_UNUSED_KEYS = frozenset({"model.23.dfl.conv.weight"})
KNOWN_UNUSED_SUFFIXES = (".num_batches_tracked",)


def _to_flax_array(torch_array: np.ndarray, leaf: str) -> np.ndarray:
    a = np.asarray(torch_array)
    if leaf == "kernel" and a.ndim == 4:  # OIHW → HWIO
        return np.transpose(a, (2, 3, 1, 0))
    if leaf == "kernel" and a.ndim == 2:  # dense (O, I) → (I, O)
        return a.T
    return a


def _from_flax_array(arr: np.ndarray, leaf: str) -> np.ndarray:
    """Inverse of _to_flax_array (torch layout from a flax leaf)."""
    a = np.asarray(arr)
    if leaf == "kernel" and a.ndim == 4:  # HWIO → OIHW
        return np.transpose(a, (3, 2, 0, 1))
    if leaf == "kernel" and a.ndim == 2:
        return a.T
    return a


def export_torch_state(variables: Mapping) -> dict[str, np.ndarray]:
    """YOLOv11 variables (the JAX tree) → ultralytics-named state dict
    (exact inverse of convert_state_dict's name map and layout
    transposes)."""
    out: dict[str, np.ndarray] = {}
    for path, leaf_val in sorted(flatten(variables)):
        tkey = _flax_path_to_torch_key(path[1:])
        if tkey in out:
            raise KeyError(f"Name map is not injective: {tkey} from {list(path)}")
        out[tkey] = _from_flax_array(np.asarray(leaf_val, np.float32), path[-1])
    return out


def reference_checkpoint_inventory(variables: Mapping) -> dict[str, tuple]:
    """The complete key → shape inventory of a real ultralytics YOLOv11
    checkpoint's state_dict as `load_ultralytics_checkpoint` returns it
    ('model.{i}.…' names plus the frozen DFL arange conv and per-BN
    `num_batches_tracked` counters); frozen in
    tests/fixtures/yolo_l_reference_checkpoint_keys.json. `variables`
    may be a `bridge.variables_template`."""
    torch_state = export_torch_state(variables)
    inv = {k: tuple(int(s) for s in np.shape(v)) for k, v in torch_state.items()}
    # one num_batches_tracked per BatchNorm (sibling of each bn.weight)
    for k in list(inv):
        if k.endswith(".bn.weight"):
            inv[k[: -len(".weight")] + ".num_batches_tracked"] = ()
    # box-branch output conv: (4*reg_max, C, kh, kw) → reg_max
    reg_max = next((int(np.shape(v)[0]) // 4 for k, v in torch_state.items()
                    if k.endswith("cv2.0.2.weight")), 16)
    inv["model.23.dfl.conv.weight"] = (1, reg_max, 1, 1)
    return inv


def convert_state_dict(torch_state: Mapping, template: Mapping) -> dict:
    """Fill the variable tree `template` (the JAX tree's paths and shapes,
    e.g. `bridge.variables_template`) with torch weights, float32.

    torch_state: flat mapping of torch parameter names → arrays (numpy or
    torch tensors). Keys may carry a 'model.model.' prefix (ultralytics
    nests the detection model once).
    Raises KeyError listing missing weights, and any checkpoint weight no
    parameter consumed beyond the documented KNOWN_UNUSED set.
    """
    norm_state: dict[str, np.ndarray] = {}
    for k, v in torch_state.items():
        k2 = k[len("model."):] if k.startswith("model.model.") else k
        norm_state[k2] = as_numpy(v)

    missing, filled = [], []
    used: set[str] = set()
    for path, leaf_val in flatten(template):
        torch_key = _flax_path_to_torch_key(path[1:])
        if torch_key not in norm_state:
            missing.append(torch_key)
            continue
        used.add(torch_key)
        arr = _to_flax_array(norm_state[torch_key], path[-1])
        if arr.shape != leaf_val.shape:
            raise ValueError(
                f"Shape mismatch for {torch_key}: torch {arr.shape} vs flax {leaf_val.shape}")
        filled.append((path, np.array(arr, np.float32)))
    if missing:
        raise KeyError(f"Missing {len(missing)} weights in checkpoint, e.g. {missing[:8]}")
    extra = [k for k in norm_state
             if k not in used and k not in KNOWN_UNUSED_KEYS
             and not k.endswith(KNOWN_UNUSED_SUFFIXES)]
    if extra:
        raise KeyError(f"{len(extra)} checkpoint weights were silently dropped, "
                       f"e.g. {sorted(extra)[:8]}")
    return nest(filled)


def expected_torch_keys(variables: Mapping) -> set[str]:
    """All torch state_dict keys this converter expects — useful to diff
    against a real checkpoint before conversion."""
    return {_flax_path_to_torch_key(path[1:]) for path, _ in flatten(variables)}


def load_ultralytics_checkpoint(path: str) -> dict:
    """Best-effort loader for a .pt checkpoint without the ultralytics
    package: the state dict of the common container layouts. The file is
    unpickled (torch.load with weights_only=False, as ultralytics saves
    model objects): convert only files you trust."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("state_dict", "model"):
            inner = obj.get(key)
            if inner is None:
                continue
            if hasattr(inner, "state_dict"):
                return dict(inner.state_dict())
            if isinstance(inner, dict):
                return inner
        if all(hasattr(v, "shape") for v in obj.values()):
            return obj
    if hasattr(obj, "state_dict"):
        return dict(obj.state_dict())
    raise ValueError(f"Unrecognized checkpoint container in {path}")
