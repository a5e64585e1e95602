"""Train the wire segmenter (SAM2 image segmenter, a Hiera preset) from
scratch on a pre-rendered pool with the PyTorch port: the loop, flags
and defaults of scripts/train_segmenter.py over the port's `train/`
(whole-tree Adam with optax's warmup-cosine schedule, the combined
loss). The pool is resized once to --res (`resize_pil_bilinear_u8`, PIL's
BILINEAR byte for byte; the masks thresholded above 127) and cached in
the pool directory as the JAX script caches it, then held on the device
as uint8 with batches gathered there. Resumable state goes to --ckpt-dir
(`train/checkpoint.save_train_state`); --save writes the final model as
the JAX script does (:220-238): an orbax checkpoint with the meta
"kind", "sam2" (preset and overrides), "sam2_config" (the config's
fields) and "train" (steps, batch, pool, held-out wire IoU), which
`--sam2-checkpoint` of either package's CLI loads. Initial weights come
from `bridge.seeded_state` (the JAX script draws flax's initializers).

Usage: python scripts/torch_train_segmenter.py --pool .train_cache/pool_v1 \\
           [--steps 6000 --batch 8 --res 512 --arch t --save .train_cache/sam2_final
            --device cuda]
"""
import argparse
import dataclasses
import glob
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_pool(pool_dir: str, res: int, limit: int = 0):
    """Every pool item resized once: (N, res, res, 3) uint8 RGB, (N, res,
    res) bool masks and the degrade tiers, cached as `_seg_{res}_{N}.npz`
    in the pool directory (the JAX script's cache, read by either)."""
    from circuitvision_tpu_torch.ops.image import resize_pil_bilinear_u8

    files = sorted(f for f in glob.glob(os.path.join(pool_dir, "*.npz"))
                   if not os.path.basename(f).startswith("_"))
    if limit:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"no pool items under {pool_dir}")
    cache = os.path.join(pool_dir, f"_seg_{res}_{len(files)}.npz")
    if os.path.exists(cache):
        with np.load(cache) as z:
            print(f"  loaded seg cache {cache} ({len(z['imgs'])} items)")
            return z["imgs"], z["masks"], [str(t) for t in z["tiers"]]
    imgs = np.zeros((len(files), res, res, 3), np.uint8)
    masks = np.zeros((len(files), res, res), bool)
    tiers = []
    for i, f in enumerate(files):
        with np.load(f, allow_pickle=False) as z:
            imgs[i] = resize_pil_bilinear_u8(z["image"], (res, res))
            masks[i] = resize_pil_bilinear_u8(z["mask"], (res, res)) > 127
            tiers.append(str(z["tier"]))
    np.savez(cache, imgs=imgs, masks=masks, tiers=np.asarray(tiers))
    return imgs, masks, tiers


def iou(pred: np.ndarray, gt: np.ndarray) -> float:
    inter = float(np.logical_and(pred, gt).sum())
    union = float(np.logical_or(pred, gt).sum())
    return inter / union if union else 1.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pool", default=".train_cache/pool_v1")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--arch", default="t", choices=("t", "s", "b+", "l"))
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--warmup-steps", type=int, default=100)
    ap.add_argument("--val-n", type=int, default=64)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--save", default=".train_cache/sam2_final",
                    help="directory of the final model checkpoint (orbax + meta.json)")
    ap.add_argument("--ckpt-dir", default=".train_cache/sam2_run")
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from circuitvision_tpu_torch.core.config import (TrainConfig, resolve_device,
                                                     sam2_hiera_preset)
    from circuitvision_tpu_torch.models import bridge
    from circuitvision_tpu_torch.models.checkpoint_writer import save_model_checkpoint
    from circuitvision_tpu_torch.models.sam2.wrapper import SAM2ImageSegmenter
    from circuitvision_tpu_torch.ops.image import normalize_imagenet
    from circuitvision_tpu_torch.train.checkpoint import (latest_checkpoint, prune_checkpoints,
                                                          restore_train_state, save_train_state)
    from circuitvision_tpu_torch.train.train_step import make_optimizer, make_train_step

    dev = resolve_device(args.device, "torch_train_segmenter")
    cfg = sam2_hiera_preset(args.arch, resolution=args.res, dtype="float32")
    imgs, masks, tiers = load_pool(args.pool, args.res, args.limit)
    n_val = min(args.val_n, len(imgs) // 4)
    n_train = len(imgs) - n_val
    print(f"pool: {n_train} train + {n_val} val ({sum(1 for t in tiers if t)} degraded)")

    meta = {"sam2": {"preset": args.arch, "overrides": {"resolution": args.res}}}
    model = SAM2ImageSegmenter(cfg)
    model.load_state_dict(bridge.seeded_state("sam2", meta, 0))
    model.to(dev)
    params = {n: p.detach() for n, p in model.named_parameters()}
    print(f"SAM2-{args.arch}@{args.res} from scratch: "
          f"{sum(p.numel() for p in params.values()):,} params")
    tcfg = TrainConfig(learning_rate=args.lr, schedule="cosine",
                       warmup_steps=args.warmup_steps, total_steps=args.steps)
    mask_all = {n: True for n in params}
    tx, _ = make_optimizer(model, tcfg, mask=mask_all)
    opt = tx.init(params)
    # whole-tree training: from scratch there is no trunk to freeze
    step = make_train_step(model, tx, tcfg, mask=mask_all, selective=False)

    imgs_dev = torch.as_tensor(imgs, device=dev)
    masks_dev = torch.as_tensor(masks, device=dev)

    def normalize(u8):
        return normalize_imagenet(u8.float() / 255.0)

    start = 0
    found = latest_checkpoint(args.ckpt_dir) if args.ckpt_dir else None
    if found:
        start = found[0]
        params, opt = restore_train_state(found[1], params, opt)
        print(f"resumed from {found[1]} (step {start})")

    val_gt, val_tiers = masks[n_train:], tiers[n_train:]

    @torch.no_grad()
    def run_eval(tag: str) -> float:
        pred = np.concatenate([
            (torch.func.functional_call(model, params, (normalize(imgs_dev[i:i + args.batch]),))
             [0][..., 0] > 0).cpu().numpy()
            for i in range(n_train, len(imgs), args.batch)])
        ious = np.asarray([iou(p, g) for p, g in zip(pred, val_gt)])
        clean = [i for i, t in enumerate(val_tiers) if not t]
        deg = [i for i, t in enumerate(val_tiers) if t]
        msg = f"[{tag}] held-out wire IoU: all {ious.mean():.4f}"
        if clean:
            msg += f"  clean {ious[clean].mean():.4f}"
        if deg:
            msg += f"  degraded {ious[deg].mean():.4f}"
        print(msg, flush=True)
        return float(ious.mean())

    run_eval(f"step {start}")
    rng = np.random.default_rng(777 + start)
    t0 = time.time()
    for i in range(start, args.steps):
        sel = torch.as_tensor(rng.integers(0, n_train, args.batch), device=dev)
        params, opt, metrics = step(params, opt, normalize(imgs_dev[sel]),
                                    masks_dev[sel].float())
        if i % args.log_every == 0 or i == args.steps - 1:
            dt = time.time() - t0
            print(f"step {i:5d}  loss {float(metrics['loss']):.4f}  "
                  f"({dt:.0f}s, {dt / max(1, i - start + 1) * 1e3:.0f} ms/step)", flush=True)
        if args.eval_every and i and i % args.eval_every == 0:
            run_eval(f"step {i}")
        if args.ckpt_dir and ((i + 1) % args.save_every == 0 or i == args.steps - 1):
            save_train_state(args.ckpt_dir, i + 1, params, opt)
            prune_checkpoints(args.ckpt_dir, keep=2)

    final_iou = run_eval("final")
    if args.save:
        save_model_checkpoint(
            os.path.abspath(args.save), bridge.variables_from_state_dict(params, model),
            meta={"kind": "sam2", **meta,
                  "sam2_config": {k: (list(v) if isinstance(v, (tuple, list)) else v)
                                  for k, v in dataclasses.asdict(cfg).items()},
                  "train": {"steps": args.steps, "batch": args.batch,
                            "pool": os.path.basename(args.pool.rstrip("/")),
                            "iou_holdout": final_iou}})
        print(f"saved model checkpoint to {args.save} (IoU {final_iou:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
