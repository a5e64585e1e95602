"""Render the synthetic eval set (images, GT boxes, GT wire masks, canned
VLM labels, pinned reference netlists) with the PyTorch port: the set
scripts/make_eval_set.py writes, with no JAX and no PIL.

Usage: python scripts/torch_make_eval_set.py [--out eval_data]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from circuitvision_tpu_torch.eval.synth import make_all_circuits, write_eval_set  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="eval_data")
    args = ap.parse_args(argv)
    circuits = make_all_circuits()
    write_eval_set(args.out, circuits)
    print(f"wrote {len(circuits)} circuits to {args.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
