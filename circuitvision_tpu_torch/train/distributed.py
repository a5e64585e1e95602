"""The SAM2 fine-tune step over a (data, model) mesh of torch.distributed
ranks — what the JAX package gets from jit with FSDP shardings
(`scripts/train_demo.py --distributed`, `tests/multihost_worker.py`).

  * **Data axis.** Each rank runs `loss_and_grads` on its own shard of the
    global batch; the trainable leaves' gradients and the metrics are
    averaged over the rank's data group, then every rank runs the same
    `Optimizer.update`. The losses are per-sample means (train/losses.py),
    so with equal shards the average is the global batch's gradient.
  * **Model axis.** Leaves the shard rule selects (`parallel.mesh.
    fsdp_shard_dims`) rest split on that dim over the model group, and so
    do Adam's moments (and the accumulated gradients): for each step the
    parameters are all-gathered whole, and each rank updates its own slice
    with its slice of the gradient. A model group's ranks share a data
    shard, so their gradients agree; the leaves they all hold whole take
    the group's mean of them, which keeps those leaves bit-equal across
    the group where a kernel's summation order varies.

A rank runs the single-device step's kernels on whole tensors, so nothing
here needs the JAX package's `multichip` flag. Parameters, state and the
batch are on the rank's device (a gloo group stages CUDA tensors through
the host itself).
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from ..core.config import TrainConfig
from ..parallel.mesh import (Mesh, all_gather_cat, all_reduce_mean, fsdp_shard_dims,
                             shard_leaf)
from .optim import apply_updates
from .train_step import Optimizer, check_flash_widths, loss_and_grads, trainable_mask
from .train_step import _trunk_diff_cutoff

#: leaves smaller than this stay whole on every rank (JAX fsdp_param_shardings)
MIN_SHARD_SIZE = 2 ** 16
#: optimizer-state entries holding one buffer per trainable leaf
_PER_LEAF = ("mu", "nu", "acc_grads")


def shard_dims(params: Mapping[str, torch.Tensor], mesh: Mesh,
               min_size: int = MIN_SHARD_SIZE) -> dict[str, Optional[int]]:
    """The dim each leaf rests split on over the model axis, or None."""
    return fsdp_shard_dims(params, mesh, mesh.axis_names[1], min_size)


def shard_params(params: Mapping[str, torch.Tensor], dims: Mapping[str, Optional[int]],
                 mesh: Mesh) -> dict[str, torch.Tensor]:
    """This rank's slices of whole parameters."""
    return {n: shard_leaf(p, dims[n], mesh) for n, p in params.items()}


def shard_opt_state(state: Mapping, dims: Mapping[str, Optional[int]], mesh: Mesh) -> dict:
    """This rank's slices of a whole optimizer state (Optimizer.init of the
    whole parameters): the per-leaf buffers as their parameters; the
    counters stay whole."""
    return {k: shard_params(v, dims, mesh) if k in _PER_LEAF else v for k, v in state.items()}


def gather_params(params: Mapping[str, torch.Tensor], dims: Mapping[str, Optional[int]],
                  mesh: Mesh) -> dict[str, torch.Tensor]:
    """Whole parameters from this rank's slices (all-gathered over the
    model group); whole leaves are the same tensors."""
    return {n: p if dims[n] is None else all_gather_cat(p, dims[n], mesh.model_group)
            for n, p in params.items()}


def make_distributed_train_step(model: torch.nn.Module, tx: Optimizer, mesh: Mesh,
                                dims: Mapping[str, Optional[int]],
                                cfg: TrainConfig | None = None,
                                mask: Mapping[str, bool] | None = None, selective: bool = True):
    """Returns train_step(params, opt_state, images, masks) → (params,
    opt_state, metrics) over this rank's slices (`shard_params`,
    `shard_opt_state` with the same `dims`) and its data shard of the
    batch (`parallel.mesh.shard_batch`); the metrics are the data group's
    average, the same on every rank. Arguments as make_train_step's."""
    cfg = cfg or TrainConfig()
    check_flash_widths(model, _trunk_diff_cutoff(trainable_mask(model) if mask is None else mask)
                       if selective else 0)

    def train_step(params, opt_state, images, masks):
        whole = gather_params(params, dims, mesh)
        _loss, metrics, grads = loss_and_grads(model, whole, images, masks, cfg, mask,
                                               selective)
        names = [n for n in grads if tx.trainable is None or n in tx.trainable]
        keys = list(metrics)
        averaged = all_reduce_mean([grads[n] for n in names] + [metrics[k] for k in keys],
                                   mesh.data_group)
        mean = dict(zip(names, averaged))
        # a model group's ranks compute one gradient each from the same
        # shard; kernels that sum in a varying order (atomics) can leave
        # their copies a rounding apart, so the leaves every rank holds
        # whole take the group's mean and stay equal on every rank
        kept = [n for n in names if dims[n] is None]
        mean.update(zip(kept, all_reduce_mean([mean[n] for n in kept], mesh.model_group)))
        local = {n: shard_leaf(mean[n], dims[n], mesh) for n in names}
        updates, opt_state = tx.update(local, opt_state)
        return (apply_updates(params, updates), opt_state,
                dict(zip(keys, averaged[len(names):])))

    return train_step
