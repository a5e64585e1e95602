"""Train the YOLOv11 detector from scratch on a pre-rendered pool with the
PyTorch port (`circuitvision_tpu_torch.train.yolo_train.train_detector`),
the flags and defaults of scripts/train_detector.py. The pool is
letterboxed once (`eval/pool.load_pool`, cached in the pool directory)
and held on the device; resumable state goes to --ckpt-dir
(`train/checkpoint.save_train_state`). --save writes the final model as
the JAX script does (`yolo_train.save_detector`): an orbax checkpoint
with its meta.json, which `--yolo-checkpoint` of either package's CLI
loads.

Usage: python scripts/torch_train_detector.py --pool .train_cache/pool_v1
           [--steps 12000 --batch 16 --device cuda]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pool", default=".train_cache/pool_v1")
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--scale", default="s", choices=list("nsmlx"))
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--warmup-steps", type=int, default=200)
    ap.add_argument("--max-gt", type=int, default=96)
    ap.add_argument("--val-n", type=int, default=96)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--eval-every", type=int, default=2000)
    ap.add_argument("--limit", type=int, default=0, help="pool size cap")
    ap.add_argument("--save", default=".train_cache/yolo_final",
                    help="directory of the final model checkpoint (orbax + meta.json)")
    ap.add_argument("--ckpt-dir", default=".train_cache/yolo_run")
    ap.add_argument("--save-every", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from circuitvision_tpu_torch.eval.pool import load_pool
    from circuitvision_tpu_torch.train.yolo_train import save_detector, train_detector

    images, boxes, tiers = load_pool(args.pool, args.img_size, args.limit)
    out = train_detector(images, boxes, tiers, scale=args.scale, img_size=args.img_size,
                         steps=args.steps, batch=args.batch, lr=args.lr,
                         warmup_steps=args.warmup_steps, max_gt=args.max_gt, val_n=args.val_n,
                         log_every=args.log_every, eval_every=args.eval_every,
                         ckpt_dir=args.ckpt_dir or None, save_every=args.save_every,
                         device=args.device)
    if args.save:
        save_detector(os.path.abspath(args.save), out, scale=args.scale, img_size=args.img_size,
                      steps=args.steps, batch=args.batch,
                      pool=os.path.basename(args.pool.rstrip("/")))
        print(f"saved model checkpoint to {args.save} "
              f"(mAP@50 {out['map']['final']['all']:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
