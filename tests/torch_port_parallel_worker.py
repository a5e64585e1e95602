"""One rank of tests/test_torch_port_parallel.py's two-rank runs.

    python tests/torch_port_parallel_worker.py RANK WORLD PORT MODE WORKDIR

Sets torchrun's environment for a one-host run on 127.0.0.1:PORT, joins
with the gloo backend on the CPU and runs MODE's checks in sequence:
"data" (a 2 × 1 mesh: mesh rules, collectives, spans, the byte gather,
distributed analysis, the data-parallel train step and two planted
faults) or "model" (a 1 × 2 mesh: the train step with sharded leaves).
Imports only the port, numpy and torch. Inputs come from WORKDIR (written
by the parent); results go to "RESULT key=value" lines and WORKDIR files.
"""
from __future__ import annotations

import json
import os
import sys


def main() -> None:
    rank, world, port, mode, workdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                        sys.argv[4], sys.argv[5])
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    torch.set_num_threads(1)
    from circuitvision_tpu_torch.parallel import multihost

    assert multihost.initialize(device="cpu", timeout_s=120)
    assert multihost.process_count() == world and multihost.backend() == "gloo"
    if mode == "data":
        run_mesh_checks(rank, world)
        run_inference(workdir)
        for variant in ("ok", "no_average", "one_shard"):
            run_train_step(rank, workdir, model_parallel=1, variant=variant)
    elif mode == "model":
        run_train_step(rank, workdir, model_parallel=2, variant="ok")
    else:
        raise SystemExit(f"unknown mode {mode}")
    multihost.sync("done")
    multihost.shutdown()


def run_mesh_checks(rank: int, world: int) -> None:
    """tests/multihost_worker.py's mesh checks with one device a rank."""
    import torch
    import torch.distributed as dist

    from circuitvision_tpu_torch.core.config import MeshConfig
    from circuitvision_tpu_torch.parallel import multihost
    from circuitvision_tpu_torch.parallel.mesh import all_gather_cat

    mesh = multihost.global_mesh(MeshConfig())
    assert mesh.shape == (world, 1) and mesh.coords == (rank, 0), (mesh.shape, mesh.coords)
    tp = multihost.global_mesh(MeshConfig(model_parallel=2))
    assert tp.shape == (world // 2, 2) and tp.coords == (0, rank), (tp.shape, tp.coords)
    # a model row of ranks inside one host: its gather in rank order
    got = all_gather_cat(torch.full((2,), float(rank)), 0, tp.model_group)
    assert got.tolist() == [0.0, 0.0, 1.0, 1.0], got
    for cfg, words in ((MeshConfig(model_parallel=3), "model axis may not cross"),
                       (MeshConfig(data_parallel=1), "incompatible with")):
        try:
            multihost.global_mesh(cfg)
            raise AssertionError(f"expected ValueError for {cfg}")
        except ValueError as e:
            assert words in str(e), e
    print(f"RESULT mesh_shape={mesh.shape}", flush=True)

    # a sum over every rank's local shard (the gradient average in miniature)
    local = (torch.arange(8, dtype=torch.float32) + 100.0 * rank).reshape(4, 2)
    total = local.sum()
    dist.all_reduce(total, group=mesh.data_group)
    print(f"RESULT global_sum={float(total)}", flush=True)

    span = multihost.local_span(8 * world)
    print(f"RESULT span={span.start}:{span.stop}", flush=True)
    b = multihost.balanced_span(5)
    print(f"RESULT balanced={b.start}:{b.stop}", flush=True)
    try:
        multihost.local_span(5)
        raise AssertionError("expected ValueError for an uneven local_span")
    except ValueError as e:
        assert "do not split evenly" in str(e), e
    gathered = multihost.gather_bytes(f"netlist-from-{rank}".encode())
    print("RESULT gathered=" + ",".join(g.decode() for g in gathered), flush=True)
    uneven = multihost.gather_bytes(b"" if rank else b"\x00\xffbytes")
    assert uneven == [b"\x00\xffbytes", b""], uneven
    multihost.sync("mesh-checks-done")


def run_inference(workdir: str) -> None:
    """analyze_many_distributed over the parent's five images (3/2 split)
    with its detections injected at the batched detection boundary."""
    import numpy as np

    from circuitvision_tpu_torch.core.config import DetectorConfig, PipelineConfig
    from circuitvision_tpu_torch.core.types import BBox
    from circuitvision_tpu_torch.enrich.client import FakeVLMClient
    from circuitvision_tpu_torch.models import bridge
    from circuitvision_tpu_torch.parallel import multihost
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch
    from circuitvision_tpu_torch.pipeline.batch import BatchedPipeline

    with np.load(os.path.join(workdir, "images.npz")) as z:
        images = [z[f"i{k}"] for k in range(len(z.files))]
    with open(os.path.join(workdir, "boxes.json")) as f:
        boxes = {tuple(json.loads(k)): v for k, v in json.load(f).items()}
    BatchedPipeline._detect_bboxes = lambda self, chunk, imgs_dev: [
        [BBox(**b) for b in boxes[img.shape]] for img in chunk]
    det = DetectorConfig(scale="n", img_size=64, dtype="float32")
    meta = {"detector": {"scale": "n", "img_size": 64, "num_classes": det.num_classes,
                         "reg_max": det.reg_max}}
    analyzer = CircuitAnalyzerTorch(
        PipelineConfig(detector=det, use_sam2=False), bridge.seeded_state("yolo", meta, 0), None,
        device="cpu", vlm_client=FakeVLMClient(directions={"voltage.dc": ("UP", "SIGN")}))
    local_results, netlists = multihost.analyze_many_distributed(analyzer, images, batch_size=4)
    assert len(local_results) == len(multihost.balanced_span(len(images)))
    assert len(netlists) == len(images)
    print("RESULT local=" + str(len(local_results)), flush=True)
    print("RESULT netlists=" + json.dumps([n["valueless"] for n in netlists]), flush=True)
    multihost.sync("infer-done")


def run_train_step(rank: int, workdir: str, model_parallel: int, variant: str) -> None:
    """One step of train/distributed.py on the parent's tiny SAM2 weights
    and global batch (4 images); the whole parameters after it, the loss
    and the sharded leaves go to WORKDIR. Planted faults: "no_average"
    leaves each rank's gradients its own, "one_shard" feeds rank 0's shard
    on every rank."""
    import numpy as np
    import torch

    from circuitvision_tpu_torch.core.config import MeshConfig, SAM2Config, TrainConfig
    from circuitvision_tpu_torch.models.sam2.wrapper import SAM2ImageSegmenter
    from circuitvision_tpu_torch.parallel import multihost
    from circuitvision_tpu_torch.parallel.mesh import shard_batch
    from circuitvision_tpu_torch.train import distributed
    from circuitvision_tpu_torch.train.train_step import make_optimizer

    with open(os.path.join(workdir, "sam2_config.json")) as f:
        cfg = SAM2Config(**json.load(f))
    model = SAM2ImageSegmenter(cfg)
    model.load_state_dict(torch.load(os.path.join(workdir, "sam2_state.pt"), weights_only=True))
    params = {n: p.detach() for n, p in model.named_parameters()}
    tx, mask = make_optimizer(model, TrainConfig())
    opt = tx.init(params)
    with np.load(os.path.join(workdir, "batch.npz")) as z:
        images, masks = z["images"], z["masks"]
    mesh = multihost.global_mesh(MeshConfig(model_parallel=model_parallel))
    dims = distributed.shard_dims(params, mesh, min_size=1024)
    saved = distributed.all_reduce_mean
    if variant == "no_average":
        distributed.all_reduce_mean = lambda tensors, group: list(tensors)
    try:
        step = distributed.make_distributed_train_step(model, tx, mesh, dims, TrainConfig(),
                                                       mask=mask)
        local_p = distributed.shard_params(params, dims, mesh)
        local_o = distributed.shard_opt_state(opt, dims, mesh)
        if variant == "one_shard":
            span = range(0, len(images) // mesh.shape[0])
            x, m = (torch.from_numpy(a[span.start:span.stop]) for a in (images, masks))
        else:
            x, m = shard_batch(images, mesh), shard_batch(masks, mesh)
        new_p, new_o, metrics = step(local_p, local_o, x, m)
    finally:
        distributed.all_reduce_mean = saved
    sharded = sorted(n for n, d in dims.items() if d is not None)
    for n in sharded:  # each rank holds its slice of the leaf and of its moments
        assert new_p[n].shape[dims[n]] * mesh.shape[1] == params[n].shape[dims[n]], n
        if n in new_o["mu"]:
            assert new_o["mu"][n].shape == new_p[n].shape, n
    whole = distributed.gather_params(new_p, dims, mesh)
    tag = f"{'model' if model_parallel > 1 else 'data'}_{variant}_rank{rank}"
    torch.save({"params": whole, "loss": float(metrics["loss"]), "sharded": sharded,
                "batch": int(x.shape[0])}, os.path.join(workdir, f"{tag}.pt"))
    print(f"RESULT {tag}_loss={float(metrics['loss'])!r}", flush=True)
    multihost.sync(f"{tag}-done")


if __name__ == "__main__":
    main()
