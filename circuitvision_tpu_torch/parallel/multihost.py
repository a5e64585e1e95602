"""Multi-process execution over torch.distributed: one process per rank,
one device per rank.

The JAX package's `parallel/multihost.py` runs one JAX process per host
and one global mesh over every chip. PyTorch's idiom is one process per
device, started by `torchrun` (or anything that sets its environment), so
here a rank is a process:

  * `initialize()` reads torchrun's environment — MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE — where the
    JAX package reads JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
    JAX_PROCESS_ID. The JAX package's TPU-pod detection (an env-only test
    for a multi-host slice, where JAX finds the coordinator itself) has no
    counterpart: a launcher always sets the environment.
  * The backend is explicit: NCCL for CUDA devices, gloo for the CPU. NCCL
    takes one rank per card; ranks that share one card (time-slicing or
    MPS) run gloo, whose all_reduce and all_gather take CUDA tensors and
    stage them through the host themselves (torch 2.11 on the H100,
    `chip_smoke.py` phase 14 checks each collective the port calls).
  * A "host" is the LOCAL_WORLD_SIZE ranks one launcher started: the model
    axis stays inside it (JAX: inside one host's ICI domain).

`local_span`, `balanced_span` and `gather_bytes` split host-side work by
rank, `analyze_many_distributed` is pure data parallelism over the
batched pipeline (no collective but the final netlist text), and `sync`
is a barrier. Single-process — no environment — every helper reduces to
the JAX package's single-process result.
"""
from __future__ import annotations

import datetime
import json
import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.config import MeshConfig
from .mesh import Mesh, make_mesh

#: torchrun's environment, every variable of which a rank needs
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
BACKENDS = ("nccl", "gloo")
#: seconds a collective (and the rendezvous) waits for the other ranks
DEFAULT_TIMEOUT_S = 1800.0

_state: dict = {}


def _rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: cuda:LOCAL_RANK for "cuda" or None, else the one
    named. A CUDA index the host lacks raises; nothing wraps or moves to
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("multihost.initialize: CUDA is not available; pass device='cpu' "
                           "(backend gloo) to run the ranks on the CPU")
    n = torch.cuda.device_count()
    index = local_rank if dev.index is None else dev.index
    if index >= n:
        named = "LOCAL_RANK" if dev.index is None else "the device named"
        raise ValueError(f"{named} gives cuda:{index}, but this host has {n} CUDA device(s); "
                         f"ranks that share a card name it (e.g. cuda:0) and run the gloo "
                         f"backend")
    return torch.device("cuda", index)


def initialize(backend: Optional[str] = None, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join this process to the ranks torchrun's environment describes.
    Idempotent. Returns False when none of ENV is set (single-process:
    every helper then degrades), True once the process group is up.

    `device`: None or "cuda" is cuda:LOCAL_RANK, "cpu" the CPU, "cuda:K"
    card K. `backend`: "nccl" (the default on CUDA) or "gloo" (the default
    on the CPU, and the one for ranks that share a card). Call it before
    any other CUDA work of the rank."""
    import torch.distributed as dist

    if _state:
        return True
    env = {k: os.environ.get(k) for k in ENV}
    given = [k for k, v in env.items() if v is not None]
    if not given:
        return False
    if len(given) < len(ENV):
        # half-configured: running single-process here would make every
        # rank analyze the whole work list on its own
        missing = [k for k in ENV if env[k] is None]
        raise ValueError(f"{'/'.join(given)} set but {'/'.join(missing)} not; refusing to "
                         f"fall back to single-process")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank, local_world = int(env["LOCAL_RANK"]), int(env["LOCAL_WORLD_SIZE"])
    dev = _rank_device(device, local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {', '.join(BACKENDS)}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {dev}")
    if world % local_world or not 0 <= rank < world or not 0 <= local_rank < local_world:
        raise ValueError(f"RANK={rank} LOCAL_RANK={local_rank} do not fit WORLD_SIZE={world} "
                         f"LOCAL_WORLD_SIZE={local_world}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        _one_rank_per_card(dev)
    _state.update(backend=backend, device=dev, local_world=local_world)
    return True


def _one_rank_per_card(dev: torch.device) -> None:
    """Raise on every rank when two NCCL ranks of one host name one card
    (NCCL would fail or hang at its first collective); the check runs on a
    gloo group, before any NCCL communicator exists."""
    import torch.distributed as dist

    check = dist.new_group(backend="gloo")
    seen: list = [None] * dist.get_world_size()
    dist.all_gather_object(seen, (socket.gethostname(), dev.index), group=check)
    dist.destroy_process_group(check)
    for where in seen:
        shared = [r for r, other in enumerate(seen) if other == where]
        if len(shared) > 1:
            dist.destroy_process_group()
            raise ValueError(f"ranks {shared} name cuda:{where[1]} on {where[0]}: NCCL takes one "
                             f"rank per card; ranks that share a card run the gloo backend")


def shutdown() -> None:
    """Leave the process group (a no-op single-process)."""
    import torch.distributed as dist

    if _state:
        dist.destroy_process_group()
        _state.clear()


def is_distributed() -> bool:
    return process_count() > 1


def process_count() -> int:
    return _world()[0]


def process_index() -> int:
    return _world()[1]


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def device() -> Optional[torch.device]:
    """This rank's device, None single-process."""
    return _state.get("device")


def backend() -> Optional[str]:
    return _state.get("backend")


def global_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """(data, model) mesh over every rank. The model axis stays inside one
    host (`model_parallel` must divide LOCAL_WORLD_SIZE): its gathers ride
    the host's links, and only the data axis's gradient average crosses
    hosts. Single-process it is `make_mesh(cfg)`, subset meshes included."""
    cfg = cfg or MeshConfig()
    nproc = process_count()
    if nproc == 1:
        return make_mesh(cfg)
    n_local = _state["local_world"]
    model = max(1, cfg.model_parallel)
    if n_local % model != 0:
        raise ValueError(f"model_parallel={model} must divide the {n_local} local ranks: the "
                         f"model axis may not cross hosts (shard models within a host only)")
    local_data = n_local // model
    hosts = nproc // n_local
    if cfg.data_parallel > 0 and cfg.data_parallel != hosts * local_data:
        raise ValueError(f"data_parallel={cfg.data_parallel} incompatible with {hosts} hosts x "
                         f"{local_data} local data-shards; use data_parallel=-1 (all ranks) for "
                         f"multi-host meshes")
    return make_mesh(cfg)


def local_span(n_global: int) -> range:
    """This rank's contiguous share of `n_global` host-side work items;
    an uneven split raises."""
    nproc, pid = _world()
    if n_global % nproc != 0:
        raise ValueError(f"{n_global} items do not split evenly over {nproc} processes; pad "
                         f"the work list or use balanced_span")
    per = n_global // nproc
    return range(pid * per, pid * per + per)


def balanced_span(n_global: int) -> range:
    """Like `local_span` for work with no device batch behind it: any
    count, the first `n_global % nproc` ranks take one item more."""
    nproc, pid = _world()
    q, r = divmod(n_global, nproc)
    start = pid * q + min(pid, r)
    return range(start, start + q + (1 if pid < r else 0))


def _comm_device() -> torch.device:
    """Where the world group's collectives take their tensors: the rank's
    card under NCCL, the host under gloo."""
    return _state["device"] if _state["backend"] == "nccl" else torch.device("cpu")


def gather_bytes(payload: bytes) -> list:
    """All-gather one byte string per rank; returns the list indexed by
    rank. Two all-gathers over the world group (lengths, then the
    payloads padded to the longest as uint8), as the JAX package does;
    a process group of one rank runs them too. Single-process (no process
    group): [payload]."""
    import torch.distributed as dist

    if not _state:
        return [payload]
    nproc = process_count()
    dev = _comm_device()
    n = torch.tensor([len(payload)], dtype=torch.int32, device=dev)
    lens = [torch.empty_like(n) for _ in range(nproc)]
    dist.all_gather(lens, n)
    lens = [int(x.item()) for x in lens]
    buf = np.zeros(max(max(lens), 1), np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    mine = torch.from_numpy(buf).to(dev)
    bufs = [torch.empty_like(mine) for _ in range(nproc)]
    dist.all_gather(bufs, mine)
    return [b[:k].cpu().numpy().tobytes() for b, k in zip(bufs, lens)]


def analyze_many_distributed(analyzer, images: Sequence[np.ndarray],
                             batch_size: Optional[int] = None, final: bool = False):
    """Pure data-parallel inference over a global image list: each rank
    runs the batched pipeline (`BatchedPipeline.analyze_many`, with
    `finalize=final`) over its `balanced_span` on its own device, and only
    the netlist text crosses ranks (`gather_bytes`). Any image count works
    on any rank count; `images` may decode on access, so a rank decodes
    only its own span.

    Returns (local_results, netlists): this rank's AnalysisResults for its
    span, and the global list of {"netlist", "valueless"} dicts in image
    order, the same on every rank. Single-process: analyze_many over every
    image. (The JAX package's `prefetch`, its stage threads' queue depth,
    has no counterpart: the port's batched path runs on one thread.)"""
    from ..pipeline.batch import BatchedPipeline

    span = balanced_span(len(images))
    pipe = BatchedPipeline(analyzer, batch_size=batch_size)
    local_results = pipe.analyze_many([images[i] for i in span], finalize=final)
    payload = json.dumps([{"netlist": r.netlist_text, "valueless": r.valueless_netlist_text}
                          for r in local_results]).encode()
    netlists: list = []
    for chunk in gather_bytes(payload):
        netlists.extend(json.loads(chunk.decode()))
    return local_results, netlists


def sync(tag: str = "circuitvision") -> None:
    """Barrier across every rank (a no-op single-process). `tag` names the
    point for a reader; torch's barrier takes no name."""
    import torch.distributed as dist

    del tag
    if not _state:
        return
    if _state["backend"] == "nccl":
        dist.barrier(device_ids=[_state["device"].index])
    else:
        dist.barrier()
