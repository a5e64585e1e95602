"""Per-class detector diagnostics with the PyTorch port: the full AP@50
table of a trained detector, with each class's ground-truth count
(scripts/eval_detector.py over `circuitvision_tpu_torch`).

Loads a detector checkpoint with its meta.json (scripts/
torch_train_detector.py --save, or the JAX trainer's) and scores it on
the tail of the training pool — the held-out slice the trainers use, or
--val-n to widen it — through the serving decode at ultralytics' val
thresholds (`train/yolo_train.eval_map50`), the pool letterboxed by
`eval/pool.load_pool`. Prints every class with its AP and ground-truth
count, weakest first, as the JAX script prints them. Runs on --device
(default cuda; cpu on request), --batch images a forward.

Usage: python scripts/torch_eval_detector.py --ckpt ckpt/yolo \\
           --pool .train_cache/pool_v1 [--val-n 200] [--device cuda]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="ckpt/yolo")
    ap.add_argument("--pool", default=".train_cache/pool_v1")
    ap.add_argument("--val-n", type=int, default=96)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from circuitvision_tpu_torch.core.config import resolve_device
    from circuitvision_tpu_torch.eval.pool import load_pool
    from circuitvision_tpu_torch.models.bridge import detector_config, state_dict_from_variables
    from circuitvision_tpu_torch.models.checkpoint import load_model_checkpoint
    from circuitvision_tpu_torch.models.yolo.model import YOLOv11
    from circuitvision_tpu_torch.train.yolo_train import eval_map50, yolo_params

    device = resolve_device(args.device, "torch_eval_detector")
    variables, meta = load_model_checkpoint(args.ckpt)
    det_cfg = detector_config(meta)
    model = YOLOv11(det_cfg.num_classes, det_cfg.scale, det_cfg.reg_max)
    model.load_state_dict(state_dict_from_variables(variables), strict=True)
    model.to(device).eval()
    images, boxes_all, tiers = load_pool(args.pool, det_cfg.img_size)
    val = slice(len(images) - args.val_n, len(images))
    val_gt = boxes_all[val]
    val_tiers = tiers[val]

    imgs = torch.from_numpy(images[val]).to(device)
    m = eval_map50(model, yolo_params(model), det_cfg, imgs, val_gt, batch=args.batch)

    counts = {}
    for bl in val_gt:
        for b in bl:
            counts[b.class_name] = counts.get(b.class_name, 0) + 1
    rows = sorted(m["per_class"].items(), key=lambda kv: kv[1])
    print(f"val images: {len(val_gt)}  ({sum(1 for t in val_tiers if t)} degraded)")
    print(f"mAP@50 all: {m['map']:.4f}")
    print(f"{'class':28s} {'AP@50':>7s} {'n_gt':>6s}")
    for cls, ap_v in rows:
        print(f"{cls:28s} {ap_v:7.3f} {counts.get(cls, 0):6d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
