"""The (data, model) grid of ranks, and the model-axis shard rule.

The JAX package's `parallel/mesh.py` lays devices out as a `jax.sharding.Mesh`
and lets XLA insert the collectives from `NamedSharding` annotations. Here
one process is one rank and holds one device (torch.distributed's own
model), so the mesh is a grid of ranks: rank r sits at (r // model, r %
model). Each rank keeps two process groups built with `dist.new_group`:

  * its **data group** — the ranks of its model column (same model index):
    the batch is split over them and their gradients are averaged;
  * its **model group** — the ranks of its data row (same data index):
    leaves the shard rule selects rest split over them and are gathered
    for each step (train/distributed.py).

Plain groups and the collectives every torch version has
(`dist.all_gather` into a list, `dist.all_reduce`), not DeviceMesh/DTensor.
`make_mesh`'s shape rule and messages are the JAX package's (`mesh_shape`,
a pure function of the world size); `fsdp_shard_dims` is
`fsdp_param_shardings`'s rule over the port's parameter dict, in the torch
layouts; `shard_batch` is this rank's slice of a global batch on its device
(JAX `batch_sharding` + `shard_batch`; a replicated leaf is simply a whole
tensor on every rank).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch

from ..core.config import MeshConfig


def mesh_shape(n: int, cfg: Optional[MeshConfig] = None) -> tuple[int, int]:
    """(data, model) of a mesh over `n` ranks (JAX make_mesh's rule):
    data_parallel -1 takes every rank the model axis leaves."""
    cfg = cfg or MeshConfig()
    model = max(1, cfg.model_parallel)
    data = cfg.data_parallel if cfg.data_parallel > 0 else n // model
    # data can floor to 0 when model > n: refuse here rather than build an
    # empty grid
    if data < 1 or data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} devices")
    return data, model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of ranks seen from one rank. `coords` is the
    rank's (data index, model index), None for a rank outside a subset
    mesh; the groups are None single-process (every collective over them
    is then the identity)."""

    shape: tuple[int, int]
    axis_names: tuple[str, str]
    rank: int
    coords: Optional[tuple[int, int]]
    data_group: object = None
    model_group: object = None

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def model_index(self) -> int:
        return self.coords[1]


def make_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The mesh of `cfg` over the ranks of the default process group (one
    rank single-process). Collective when distributed: every rank must call
    it, in the same order as any other group it builds."""
    import torch.distributed as dist

    cfg = cfg or MeshConfig()
    live = dist.is_available() and dist.is_initialized()
    n, rank = (dist.get_world_size(), dist.get_rank()) if live else (1, 0)
    data, model = mesh_shape(n, cfg)
    coords = divmod(rank, model) if rank < data * model else None
    groups = {}
    if live and n > 1:
        # every rank builds every group, in one order (dist.new_group's rule)
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if coords is not None and coords[1] == m:
                groups["data_group"] = g
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if coords is not None and coords[0] == d:
                groups["model_group"] = g
    return Mesh((data, model), (cfg.data_axis, cfg.model_axis), rank, coords, **groups)


def fsdp_shard_dims(params: Mapping[str, torch.Tensor], mesh: Mesh, axis: str = "model",
                    min_size: int = 2 ** 16) -> dict[str, Optional[int]]:
    """{name: the dim a leaf rests split on over `axis`, or None}: the
    largest trailing dim that the axis size divides, for leaves of at
    least `min_size` elements (JAX fsdp_param_shardings); small leaves,
    and every leaf on an axis of size 1, stay whole."""
    axis_size = mesh.axis_size(axis)

    def dim_for(leaf: torch.Tensor) -> Optional[int]:
        if axis_size == 1 or leaf.numel() < min_size:
            return None
        for d in range(leaf.dim() - 1, -1, -1):  # prefer trailing dims
            if leaf.shape[d] % axis_size == 0 and leaf.shape[d] >= axis_size:
                return d
        return None

    return {n: dim_for(p) for n, p in params.items()}


def shard_leaf(leaf: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a whole leaf along `dim` over the model axis
    (the whole leaf when `dim` is None)."""
    if dim is None:
        return leaf
    return leaf.chunk(mesh.shape[1], dim)[mesh.model_index].contiguous()


def all_reduce_mean(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Each tensor averaged over `group` (summed, then divided by the
    group's size, in the tensor's dtype); the identity without a group or
    in a group of one. The tensors are flattened into one buffer per
    dtype, one collective each."""
    import torch.distributed as dist

    if group is None or not tensors or dist.get_world_size(group) == 1:
        return list(tensors)
    size = dist.get_world_size(group)
    out: list = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        buf = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(buf, group=group)
        buf = buf / size
        for i, piece in zip(idx, buf.split([tensors[i].numel() for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole leaf from every rank's slice along `dim`, in the group's
    rank order (`dist.all_gather` into a list); `t` itself without a
    group."""
    import torch.distributed as dist

    if group is None:
        return t
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim)


def data_span(n_global: int, mesh: Mesh) -> range:
    """The items of a global batch of `n_global` that this rank's data
    index holds; every rank of a model group holds the same ones. An
    uneven split raises, as a batch sharded over the data axis must."""
    data = mesh.shape[0]
    if n_global % data != 0:
        raise ValueError(f"a batch of {n_global} does not split evenly over the {data} "
                         f"ranks of the data axis")
    per = n_global // data
    start = mesh.data_index * per
    return range(start, start + per)


def shard_batch(x, mesh: Mesh, device=None) -> torch.Tensor:
    """This rank's data shard of a global host batch (numpy or tensor),
    on `device` (JAX shard_batch places the whole batch over the mesh)."""
    span = data_span(len(x), mesh)
    return torch.as_tensor(x[span.start:span.stop], device=device)
