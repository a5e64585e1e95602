"""Train the crop reader (class, printed value, polarity) from scratch with
the PyTorch port (`circuitvision_tpu_torch.train.reader.train_reader`),
the flags and defaults of scripts/train_reader_demo.py: crops from
rendered circuits, held on the device, then the held-out product metrics
through the serving client. --out writes the trained reader as the JAX
script does (`reader.save_reader`): a bare orbax checkpoint of its
variables, which CIRCUITVISION_VLM=reader:<dir> loads in either package.

Usage: python scripts/torch_train_reader.py [--steps 4000 --device cuda]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--train-circuits", type=int, default=1200)
    ap.add_argument("--val-circuits", type=int, default=60)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--out", default=None,
                    help="save the trained reader here (orbax checkpoint)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from circuitvision_tpu_torch.train.reader import (evaluate_product,
                                                      generate_reader_dataset, save_reader,
                                                      train_reader)

    t0 = time.time()
    data = generate_reader_dataset(args.train_circuits, seed0=50_000)
    print(f"dataset: {data['crops'].shape[0]} crops from {args.train_circuits} circuits "
          f"({time.time() - t0:.0f}s)")
    t0 = time.time()
    out = train_reader(data, steps=args.steps, batch=args.batch, lr=args.lr,
                       log_every=args.log_every, device=args.device)
    dt = time.time() - t0
    print(f"trained in {dt:.0f}s ({dt / max(1, args.steps) * 1e3:.1f} ms/step)")
    report = evaluate_product(out["params"], args.val_circuits, seed0=990_000, device=args.device)
    print("held-out product metrics:", {k: (round(v, 4) if isinstance(v, float) else v)
                                        for k, v in report.items()})
    if args.out:
        save_reader(args.out, out)
        print(f"saved reader checkpoint to {args.out}")
    losses = [h["loss"] for h in out["history"]]
    if args.steps >= 1000:
        assert losses[-1] < losses[0], "loss did not decrease"
        assert report["row_exact_match"] >= 0.9, \
            f"row exact-match {report['row_exact_match']:.3f} < 0.9"
        print("READER OK (>=90% held-out row exact-match)")
    else:
        print(f"(short run: {args.steps} steps — bars skipped)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
