"""Fine-tune convergence demo on the PyTorch port: scripts/train_demo.py's
loop, flags, defaults and refusals over the port's `train/`.

A small-config SAM2 with a frozen random trunk is trained on synthetic
circuit renders (white background, black wires); the held-out wire-mask
IoU rises from ~0 to a real segmentation. Surfaces:
  --surface reference  (default) only the reference LoRA-parity surface
                       (prompts, decoder, refinement, conv_s0/s1, neck
                       tail, last trunk blocks) — the product setup;
  --surface full       the whole tree (sanity upper bound);
  --surface lora       rank-r factored adapters (train/lora.py).

`--distributed` makes this process one rank of a torch.distributed run
(torchrun's environment: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK, LOCAL_WORLD_SIZE; parallel/multihost.py): the data-parallel
step of train/distributed.py, every rank building the global batch and
feeding its own shard (with --data, its shard of the dataset), the
gradients and metrics averaged over the ranks. Initial weights come from
`bridge.seeded_state` (the JAX script draws flax's initializers).

Usage: python scripts/torch_train_demo.py [--steps 300] [--batch 8]
           [--surface reference|full|lora] [--device cuda|cpu]
       torchrun --nproc-per-node 2 scripts/torch_train_demo.py --distributed \\
           --device cpu --steps 2 --res 64
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: scripts/train_demo.py's small SAM2 (SAM2Config's other fields: the L defaults)
SMALL = dict(embed_dim=48, num_heads=2, stages=(1, 2, 4, 1), global_att_blocks=(5,),
             window_spec=(8, 4, 8, 4), backbone_channel_list=(384, 192, 96, 48),
             decoder_mlp_dim=256, dtype="float32")


def small_cfg(resolution=256):
    from circuitvision_tpu_torch.core.config import SAM2Config

    return SAM2Config(resolution=resolution, **SMALL)


def make_batch(rng_seed: int, n: int, res: int):
    """n synthetic circuits → (images (n,res,res,3) normalized, masks
    (n,res,res) float 0/1), numpy float32."""
    import torch

    from circuitvision_tpu_torch.eval.randomized import random_circuit
    from circuitvision_tpu_torch.eval.synth import _render_image
    from circuitvision_tpu_torch.ops.image import resize_linear, sam2_preprocess

    imgs = np.zeros((n, res, res, 3), np.float32)
    masks = np.zeros((n, res, res), np.float32)
    for i in range(n):
        mask, boxes = random_circuit(rng_seed + i)
        image = _render_image(mask, boxes)
        imgs[i] = sam2_preprocess(torch.from_numpy(image), res).numpy()
        m = resize_linear(torch.from_numpy(mask).to(torch.float32), (res, res)).numpy()
        masks[i] = (m > 127.0).astype(np.float32)
    return imgs, masks


def multisteps_mini_step(opt_state) -> int:
    """Micro-steps accumulated since the last flush (0 without
    accumulation): the EMA's flush phase after a resume."""
    return int(opt_state["mini_step"]) if "mini_step" in opt_state else 0


def mask_iou(pred: np.ndarray, gt: np.ndarray) -> float:
    inter = float(np.logical_and(pred, gt).sum())
    union = float(np.logical_or(pred, gt).sum())
    return inter / union if union else 1.0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--surface", choices=("reference", "full", "lora"), default="reference",
                    help="reference = train the LoRA-parity surface directly; full = "
                         "whole-tree sanity bound; lora = true rank-r factored adapters "
                         "(train/lora.py, reference PEFT setup)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", choices=("constant", "cosine"), default="constant")
    ap.add_argument("--warmup-steps", type=int, default=0,
                    help="linear LR warmup length, counted in optimizer UPDATES (with "
                         "--grad-accum k, one update per k micro-steps)")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="average gradients over k micro-batches per optimizer update "
                         "(effective batch = k x --batch)")
    ap.add_argument("--ema-decay", type=float, default=0.0,
                    help="EMA decay for an eval-weights shadow of the trainable leaves "
                         "(0 = off); final IoU is reported for both raw and EMA weights")
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default=None,
                    help="save/resume dir; resumes from the newest committed step "
                         "automatically")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--distributed", action="store_true",
                    help="one rank of a torch.distributed run (torchrun's environment: "
                         "MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK/LOCAL_RANK/"
                         "LOCAL_WORLD_SIZE): the data-parallel step, each rank feeding its "
                         "shard of the batch; run one copy of this script per rank")
    ap.add_argument("--data", default=None,
                    help="fine-tune on a real dataset (<root>/images + <root>/masks, "
                         "train/data.py) instead of the synthetic generator; IoU is then "
                         "reported on the dataset's first 16 items")
    ap.add_argument("--res", type=int, default=256,
                    help="input resolution (64 for a quick CPU smoke)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; with --distributed cuda:LOCAL_RANK), cuda:K or cpu")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="with --distributed: nccl (the default on the card, one rank per "
                         "card) or gloo (the CPU, and ranks that share one card)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

    import torch

    from circuitvision_tpu_torch.core.config import TrainConfig, resolve_device
    from circuitvision_tpu_torch.models import bridge
    from circuitvision_tpu_torch.models.sam2.wrapper import SAM2ImageSegmenter
    from circuitvision_tpu_torch.parallel import multihost
    from circuitvision_tpu_torch.train.train_step import (make_optimizer, make_train_step,
                                                          trainable_mask)

    dev = None
    if args.distributed:
        # before any other CUDA work of the rank
        if multihost.initialize(backend=args.backend, device=args.device):
            dev = multihost.device()
        if args.ckpt_dir:
            raise SystemExit(
                "--ckpt-dir with --distributed is not supported by this "
                "demo (single-host orbax writer); checkpoint from the "
                "production trainer instead"
            )
    dev = dev or resolve_device(args.device, "torch_train_demo")

    cfg = small_cfg(args.res)
    # total_steps/warmup_steps count optimizer UPDATES: with --grad-accum k
    # the k micro-steps of --steps collapse into steps//k updates
    n_updates = max(1, args.steps // max(1, args.grad_accum))
    tcfg = TrainConfig(
        learning_rate=args.lr,
        schedule=args.schedule,
        warmup_steps=args.warmup_steps,
        total_steps=n_updates if args.schedule == "cosine" else 0,
        grad_accum_steps=args.grad_accum,
        ema_decay=args.ema_decay,
    )
    model = SAM2ImageSegmenter(cfg)
    model.load_state_dict(bridge.seeded_state(
        "sam2", {"sam2": {"preset": "l", "overrides": {"resolution": args.res, **SMALL}}}, 0))
    model.to(dev)
    variables = {n: p.detach() for n, p in model.named_parameters()}
    n_total = sum(p.numel() for p in variables.values())

    materialize_for_eval = lambda state: state  # noqa: E731
    mask = None
    if args.surface == "lora":
        if args.distributed:
            raise SystemExit(
                "--surface lora with --distributed is not wired in this "
                "demo; use train/lora.py's API with your own mesh"
            )
        from circuitvision_tpu_torch.train import lora as lora_mod

        base_variables = variables
        tstate = lora_mod.init_train_state(model, torch.Generator().manual_seed(7), tcfg,
                                           n_trunk_blocks=sum(cfg.stages))
        tx = lora_mod.make_lora_optimizer(tcfg)
        opt_state = tx.init(lora_mod.flat_names(tstate))
        n_train = sum(p.numel() for p in lora_mod.flat_names(tstate).values())
        print(f"surface=lora: {n_train:,} adapter+direct params over a "
              f"{n_total:,}-param frozen base "
              f"(rank {tcfg.lora_rank}, alpha {tcfg.lora_alpha:g})")
        lstep = lora_mod.make_lora_train_step(model, tx, tcfg)

        def step(state, opt_state, images, masks):
            return lstep(base_variables, state, opt_state, images, masks)

        materialize_for_eval = lambda state: lora_mod.materialize(  # noqa: E731
            model, base_variables, state, tcfg)
        variables = tstate  # the loop and checkpoint carry the adapter state
    else:
        if args.surface == "reference":
            mask = trainable_mask(model)
        else:
            mask = {n: True for n in variables}
        n_train = sum(p.numel() for n, p in variables.items() if mask[n])
        print(f"surface={args.surface}: {n_train:,}/{n_total:,} params "
              f"trainable ({100 * n_train / n_total:.1f}%)")
        tx, _ = make_optimizer(model, tcfg, mask=mask)
        opt_state = tx.init(variables)

    ema_state = None
    if args.ema_decay > 0.0:
        if args.surface == "lora":
            raise SystemExit("--ema-decay with --surface lora is not "
                             "wired in this demo")
        from circuitvision_tpu_torch.train.train_step import ema_params, init_ema, update_ema

        ema_state = init_ema(variables, mask)

        def ema_step_fn(e, p):
            return update_ema(e, p, args.ema_decay)

    mesh = dims = None
    if args.surface == "lora":
        pass  # step built above; --distributed refused earlier
    elif args.distributed:
        from circuitvision_tpu_torch.core.config import MeshConfig
        from circuitvision_tpu_torch.train import distributed

        # data-parallel mesh (model_parallel=1): every leaf whole on every
        # rank, the batch split over the ranks, the gradient average the
        # only collective. The data x model step is held in
        # tests/test_torch_port_parallel.py.
        mesh = multihost.global_mesh(MeshConfig())
        dims = distributed.shard_dims(variables, mesh)
        step = distributed.make_distributed_train_step(model, tx, mesh, dims, tcfg, mask=mask)
        variables = distributed.shard_params(variables, dims, mesh)
        opt_state = distributed.shard_opt_state(opt_state, dims, mesh)
        print(f"distributed: {multihost.process_count()} process(es), "
              f"mesh {dict(zip(mesh.axis_names, mesh.shape))}, {dev}, "
              f"{multihost.backend() or 'no process group'}")
    else:
        step = make_train_step(model, tx, tcfg, mask=mask)

    start_step = 0
    if args.ckpt_dir:
        from circuitvision_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                              prune_checkpoints,
                                                              restore_train_state,
                                                              save_train_state)

        found = latest_checkpoint(args.ckpt_dir)
        if found:
            start_step = found[0]
            if ema_state is not None:
                variables, opt_state, ema_state = restore_train_state(
                    found[1], variables, opt_state, extra=ema_state)
            else:
                variables, opt_state = restore_train_state(found[1], variables, opt_state)
            print(f"resumed from {found[1]} (step {start_step})")

    # flush phase of the EMA: micro-steps already in the (restored) accumulator
    ema_mini0 = 0
    if ema_state is not None and args.grad_accum > 1:
        ema_mini0 = multisteps_mini_step(opt_state)

    @torch.no_grad()
    def fwd(params, x):
        return torch.func.functional_call(model, params, (x,))[0]

    data_iter = None
    if args.data:
        from circuitvision_tpu_torch.train.data import SegmentationFolderDataset

        shard, per_batch = None, args.batch
        if mesh is not None:
            shard = (mesh.data_index, mesh.shape[0])
            per_batch = max(1, args.batch // mesh.shape[0])
        ds = SegmentationFolderDataset(args.data, resolution=cfg.resolution, device=dev)
        data_iter = ds.batches(per_batch, seed=1000, epochs=None, augment=True, shard=shard)
        n_val = min(16, len(ds))
        val = [ds.load(i) for i in range(n_val)]
        val_imgs = torch.stack([v[0] for v in val])
        val_masks = torch.stack([v[1] for v in val]).cpu().numpy()
        print(f"dataset: {len(ds)} pairs from {args.data} "
              f"(per-process batch {per_batch})")
    else:
        # held-out eval circuits
        val_imgs, val_masks = make_batch(990000, 16, cfg.resolution)
        val_imgs = torch.from_numpy(val_imgs).to(dev)

    def eval_iou(params) -> float:
        params = materialize_for_eval(params)  # lora: fold into the base
        if mesh is not None:
            params = distributed.gather_params(params, dims, mesh)
        logits = fwd(params, val_imgs)[..., 0].float().cpu().numpy()
        return float(np.mean([mask_iou(logits[i] > 0, val_masks[i] > 0.5)
                              for i in range(logits.shape[0])]))

    iou0 = eval_iou(variables)
    print(f"held-out wire IoU before training: {iou0:.4f}")

    t0 = time.time()
    loss_first = loss = None
    for i in range(start_step, args.steps):
        if data_iter is not None:
            images, masks_b = next(data_iter)  # already this rank's shard
        else:
            images, masks_b = make_batch(1000 + i * args.batch, args.batch, cfg.resolution)
            if mesh is not None:
                from circuitvision_tpu_torch.parallel.mesh import shard_batch

                # the deterministic global batch; each rank feeds its shard
                images = shard_batch(images, mesh, dev)
                masks_b = shard_batch(masks_b, mesh, dev)
            else:
                images, masks_b = torch.from_numpy(images).to(dev), torch.from_numpy(masks_b).to(dev)
        variables, opt_state, metrics = step(variables, opt_state, images, masks_b)
        if ema_state is not None and (ema_mini0 + i - start_step + 1) % args.grad_accum == 0:
            # with accumulation, only flush steps move the parameters
            ema_state = ema_step_fn(ema_state, variables)
        if i % args.log_every == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            if loss_first is None:
                loss_first = loss
            print(f"step {i:4d}  loss {loss:.4f}  "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if args.ckpt_dir and ((i + 1) % args.save_every == 0 or i == args.steps - 1):
            save_train_state(args.ckpt_dir, i + 1, variables, opt_state, extra=ema_state)
            prune_checkpoints(args.ckpt_dir, keep=args.keep)
    iou1 = eval_iou(variables)
    if ema_state is not None:
        print(f"held-out wire IoU with EMA weights "
              f"(decay {args.ema_decay:g}): "
              f"{eval_iou(ema_params(variables, ema_state)):.4f}")
    dt = time.time() - t0
    if loss is None:  # resumed at/after --steps; nothing trained this run
        print(f"held-out wire IoU at restore: {iou1:.4f}")
        multihost.shutdown()
        return
    n_run = args.steps - start_step  # steps actually executed THIS run
    print(f"held-out wire IoU after {args.steps} steps: {iou1:.4f} "
          f"(was {iou0:.4f}); loss {loss_first:.4f} -> {loss:.4f}; "
          f"{dt:.1f}s total, {dt / n_run * 1e3:.0f} ms/step")
    if n_run >= 100:  # convergence bars calibrated for real runs
        assert loss < loss_first, "loss did not decrease"
        if args.data is None:  # bar calibrated on the synthetic set
            assert iou1 > iou0 + 0.1, "IoU did not improve"
    else:
        print(f"(short run: {n_run} steps — convergence bars skipped)")
    multihost.shutdown()
    print("TRAIN DEMO OK")


if __name__ == "__main__":
    main()
