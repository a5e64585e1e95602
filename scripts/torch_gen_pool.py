"""Pre-render the shared detector/segmenter/reader training pool with the
PyTorch port (`circuitvision_tpu_torch.eval.pool.write_pool`): the items
scripts/gen_pool.py renders, byte for byte, with no JAX and no PIL.

Usage: python scripts/torch_gen_pool.py --out .train_cache/pool_v1 --n 2600
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from circuitvision_tpu_torch.eval.pool import write_pool  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=".train_cache/pool_v1")
    ap.add_argument("--n", type=int, default=2600)
    ap.add_argument("--seed0", type=int, default=100000)
    ap.add_argument("--handdrawn-frac", type=float, default=0.25)
    ap.add_argument("--degrade-frac", type=float, default=0.40)
    args = ap.parse_args(argv)
    t0 = time.time()
    write_pool(args.out, args.n, seed0=args.seed0, handdrawn_frac=args.handdrawn_frac,
               degrade_frac=args.degrade_frac)
    print(f"pool complete: {args.n} items in {args.out} ({time.time() - t0:.0f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
