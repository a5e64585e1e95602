"""Weight-only int8 for the PaliGemma decode path: the JAX package's
`models/paligemma/quant.py` in numpy and torch.

A decode step reads the decoder projections (18 layers of q/k/v/o and
the GeGLU MLP) and the tied embedding LM head, about 2.5 B parameters.
Storing them int8 with per-output-channel (per-row for the embedding)
float32 scales halves that read; `gemma.QuantDense` and
`model.QuantEmbed` apply the scales after the product.

Scope: decoder projections and the embedding. The vision tower and the
projector run once per image inside prefill and keep their float
weights; the tower's own q/k/v/out projections are left alone.

Symmetric per-channel int8: scale = max|w| / 127 (1 for an all-zero
channel), q = clip(rint(w / scale), -127, 127). When a checkpoint's
weights are exactly int8 × 2^-k the quantization is exact, and so are
the logits: a power-of-two scale commutes with every rounding
(tests/test_torch_port_paligemma.py holds them bitwise).

`quantize_variables` works on the JAX package's variable tree of numpy
arrays; `quantize_variables_on_device` does the same arithmetic with
torch ops on a device, bit for bit, consuming its input tree leaf by leaf
so the float copy of a matrix is freed once its int8 copy exists.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.config import resolve_device

_PROJ_NAMES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
)


def _quantize_matrix(w: np.ndarray, axis: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 along `axis` (the NON-reduced, per-scale axis)."""
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.abs(w).max(axis=reduce_axes)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    expand = [None if i != axis else slice(None) for i in range(w.ndim)]
    q = np.clip(np.rint(w / scale[tuple(expand)]), -127, 127).astype(np.int8)
    return q, scale


def _quantize_matrix_torch(w: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`_quantize_matrix` with torch ops on `w`'s device: float32
    division, round-half-even, the same clip. Both divisions are by
    tensors: on the card PyTorch divides by a Python scalar as a product
    with its reciprocal, which rounds otherwise than numpy's division."""
    w = w.float()
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
    amax = w.abs().amax(dim=reduce_axes)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    shape = [-1 if i == axis else 1 for i in range(w.ndim)]
    q = torch.clamp(torch.round(w / scale.view(shape)), -127, 127).to(torch.int8)
    return q, scale


def _walk(tree: dict, path: tuple, quantize_matrix, leaf=lambda v: v,
          consume: bool = False) -> dict:
    out = {}
    for k in list(tree):
        v = tree.pop(k) if consume else tree[k]
        if isinstance(v, dict):
            # Projections only under the DECODER — the vision tower
            # has same-named q/k/v/o modules and stays float.
            if k in _PROJ_NAMES and "kernel" in v and "decoder" in path:
                q, scale = quantize_matrix(leaf(v.pop("kernel") if consume else v["kernel"]),
                                           axis=1)
                out[k] = {"kernel_q": q, "scale": scale}
            elif k == "embed_tokens" and "embedding" in v:
                q, scale = quantize_matrix(
                    leaf(v.pop("embedding") if consume else v["embedding"]), axis=0)
                out[k] = {"embedding_q": q, "scale": scale}
            else:
                out[k] = _walk(v, path + (k,), quantize_matrix, leaf, consume)
        else:
            out[k] = leaf(v)
    return out


def quantize_variables(variables: dict) -> dict:
    """Float PaliGemma params → the quant_int8=True tree.

    Decoder layer projections: kernel (in, out) → kernel_q int8 +
    per-out-channel scale (out,). Embedding (V, C) → embedding_q int8 +
    per-row scale (V,). Everything else passes through unchanged.
    Use with PaliGemmaConfig(text=...quant_int8=True)."""
    return _walk(variables, (), lambda w, axis: _quantize_matrix(np.asarray(w), axis))


def quantize_variables_on_device(variables: dict, device=None) -> dict:
    """quantize_variables with torch ops on the device, bit for bit.

    Leaves may be tensors or numpy arrays; each is moved to `device`
    (default: a tensor leaf stays where it is, a numpy leaf goes to
    CUDA) one at a time, so a tree
    read on the host never lies whole on the device in float. The input
    tree is consumed — emptied as its leaves are quantized or moved —
    so a float matrix is freed once its int8 copy exists, unless the
    caller still holds it."""
    dev = None if device is None else resolve_device(device, "quantize_variables_on_device")

    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v if dev is None else v.to(dev)
        return torch.from_numpy(np.array(v)).to(
            dev or resolve_device("cuda", "quantize_variables_on_device"))

    return _walk(variables, (), _quantize_matrix_torch, leaf, consume=True)
