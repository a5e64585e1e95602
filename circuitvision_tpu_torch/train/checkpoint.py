"""Interruptible fine-tune runs: save/restore (step, params, optimizer
state[, extra]) — the JAX package's `train/checkpoint.py` without orbax.

  - `save_train_state` writes step N atomically: a payload directory
    `step_{:08d}` holding `state.pt` (torch.save of plain dicts of
    tensors), then a sibling `.DONE` commit marker — an interrupted write
    is never picked up by `latest_checkpoint`;
  - `restore_train_state` is template-driven: it restores onto freshly
    made (params, opt_state[, extra]) — the structure, each leaf's dtype
    and device come from the templates — loading with weights_only=True;
  - resume is bit-exact: continuing from a checkpoint reproduces the
    uninterrupted run (tests/test_torch_port_train.py);
  - `restore_jax_train_state` reads a train checkpoint the JAX package
    wrote (orbax: {"params", "opt_leaves"[, "extra_leaves"]}) through the
    port's own orbax reader (models/checkpoint.py) into the port's state.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Mapping

import torch

from ..core.config import resolve_device

_STEP_FMT = "step_{:08d}"
_STEP_RE = re.compile(r"^step_(\d{8})$")
_PAYLOAD = "state.pt"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), _STEP_FMT.format(step))


def _marker(path: str) -> str:
    return path + ".DONE"


def _flat(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """Nested dicts (and lists) of tensors → {"a/b/c": tensor}."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _payload(params: Any, opt_state: Any, extra: Any = None) -> dict:
    payload = {"params": _flat(params), "opt": _flat(opt_state)}
    if extra is not None:
        payload["extra"] = _flat(extra)
    return {part: {k: v.detach().cpu() for k, v in leaves.items()}
            for part, leaves in payload.items()}


def save_train_state(ckpt_dir: str, step: int, params: Any, opt_state: Any,
                     extra: Any = None) -> str:
    """Write the checkpoint of `step` under ckpt_dir; returns its path. The
    commit marker is written only after the payload is complete."""
    path = _step_dir(ckpt_dir, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(_marker(path)):
        os.remove(_marker(path))
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    tmp = os.path.join(path, _PAYLOAD + ".tmp")
    torch.save(_payload(params, opt_state, extra), tmp)
    os.replace(tmp, os.path.join(path, _PAYLOAD))
    with open(_marker(path), "w") as f:
        f.write(str(step))
    return path


def _committed(ckpt_dir: str) -> list[tuple[int, str]]:
    ckpt_dir = os.path.abspath(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        path = os.path.join(ckpt_dir, name)
        if m and os.path.isdir(path) and os.path.exists(_marker(path)):
            out.append((int(m.group(1)), path))
    return sorted(out)


def latest_checkpoint(ckpt_dir: str) -> tuple[int, str] | None:
    """(step, path) of the newest COMMITTED checkpoint, or None."""
    found = _committed(ckpt_dir)
    return found[-1] if found else None


def _restore_tree(saved: Mapping[str, torch.Tensor], template: Any, what: str):
    """The template's structure with each leaf from `saved` (by its path),
    cast to the template leaf's dtype and moved to its device."""
    flat = _flat(template)
    if set(saved) != set(flat):
        missing, extra = sorted(set(flat) - set(saved)), sorted(set(saved) - set(flat))
        raise ValueError(f"{what}: checkpoint tree does not match the template — missing "
                         f"{missing[:5]}, unexpected {extra[:5]} (model or optimizer config "
                         "changed since save?)")

    def build(node, prefix=""):
        if isinstance(node, Mapping):
            return {k: build(v, f"{prefix}/{k}" if prefix else str(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(node))
        got = saved[prefix]
        if tuple(got.shape) != tuple(node.shape):
            raise ValueError(f"{what}: leaf {prefix} has shape {tuple(got.shape)}, template "
                             f"{tuple(node.shape)}")
        return got.to(dtype=node.dtype, device=node.device)

    return build(template)


def restore_train_state(path: str, params: Any, opt_state: Any, extra: Any = None):
    """(params, opt_state[, extra]) from a checkpoint path onto templates.
    With `extra` the 3-tuple; a checkpoint written without extra state (or
    vice versa) raises — save and restore must agree on it."""
    payload = torch.load(os.path.join(path, _PAYLOAD), map_location="cpu", weights_only=True)
    new_params = _restore_tree(payload["params"], params, "params")
    new_opt = _restore_tree(payload["opt"], opt_state, "optimizer state")
    if extra is None:
        if "extra" in payload:
            raise ValueError("checkpoint holds extra (EMA) state; pass its template")
        return new_params, new_opt
    if "extra" not in payload:
        raise ValueError("checkpoint holds no extra (EMA) state")
    return new_params, new_opt, _restore_tree(payload["extra"], extra, "extra state")


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Keep the newest `keep` committed checkpoints; delete the rest
    (markers first, so a crash mid-prune never leaves a committed-looking
    partial directory)."""
    if keep < 1:
        return
    for _step, path in _committed(ckpt_dir)[:-keep]:
        os.remove(_marker(path))
        shutil.rmtree(path, ignore_errors=True)


def restore_jax_train_state(path: str, trainable, cfg, extra: bool = False, device="cuda"):
    """A train checkpoint the JAX package wrote (its save_train_state of a
    make_optimizer state) → the port's (params, opt_state[, ema]), read
    by the port's orbax reader. `trainable`: port names of the trainable
    leaves (the optimizer's mask); `cfg`: the run's TrainConfig, which
    fixes the optimizer's leaves in JAX's order — [mini_step,
    gradient_step] with accumulation, count, mu and nu of the trainable
    leaves, the schedule's count where the LR is a schedule, then
    acc_grads with accumulation. Every moment takes its parameter's
    layout in the port. The tensors land on `device`: the card unless
    another device (such as "cpu") is asked for; the step counts stay
    int32 scalars on the CPU, as the optimizer's init makes them."""
    from ..models.bridge import leaves_in_jax_order, port_tree
    from ..models.checkpoint import load_variables
    from .train_step import learning_rate_schedule

    device = resolve_device(device, "restore_jax_train_state")
    tree = load_variables(path)
    params = port_tree(tree["params"], device)
    n = len(set(trainable))

    def leaves_of(arrays):
        return leaves_in_jax_order(tree["params"], trainable, arrays, device)

    def scalar(a):
        return torch.tensor(int(a), dtype=torch.int32)

    leaves = list(tree["opt_leaves"])
    state = {}
    accumulate = cfg.grad_accum_steps > 1
    if accumulate:
        state["mini_step"], state["gradient_step"] = scalar(leaves[0]), scalar(leaves[1])
        leaves = leaves[2:]
    state["count"] = scalar(leaves[0])
    state["mu"], state["nu"] = leaves_of(leaves[1:1 + n]), leaves_of(leaves[1 + n:1 + 2 * n])
    rest = leaves[1 + 2 * n:]
    if callable(learning_rate_schedule(cfg)):
        state["schedule_count"], rest = scalar(rest[0]), rest[1:]
    if accumulate:
        state["acc_grads"], rest = leaves_of(rest[:n]), rest[n:]
    if rest:
        raise ValueError(f"{path}: {len(rest)} optimizer leaves left over; the checkpoint's "
                         "optimizer does not match cfg")
    if not extra:
        return params, state
    return params, state, leaves_of(tree["extra_leaves"])
