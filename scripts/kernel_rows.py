#!/usr/bin/env python3
"""chip_smoke.py's kernel phases alone, for the kernels named.

    python3 scripts/kernel_rows.py [--tree OTHER_TREE] [--path PATH] [kernel ...]
        (default kernels: flash_attn mlp_block)

Runs `chip_smoke.run_kernels` at every shape of the named kernels on the
paths that launch them — L@1024 and t@512, the batched path's two
off-path rasters (600×800, 600×1003, 1×1) for the line enhancement, the trunk
LayerNorm widths for the LayerNorms, the fine-tune's global shapes
(L@1024, heads of 72; t@1024, heads of 96) for FlashAttention's three
kernels — each against its plain version on
the card, in bfloat16 and float32, with device times (CUDA-graph replay),
eager times, bound and library time, and prints chip_smoke.py's
per-shape JSON rows, then per path the sums over the path's launches
(bfloat16, and the float32 instances' under "f32"), and the launch-floor
row. It builds only what those kernels need, so a
kernel change can be measured without the whole smoke run. With --tree
the kernels, wrappers and build are OTHER_TREE's (another checkout, e.g.
the parent's from `git archive`), timed by this tree's harness — the
parent's device times beside this tree's in one call; the launch floor
is then not timed. --path keeps only that path's shapes (e.g. "train"
for a parent whose kernels take no t@1024 heads). Needs a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

#: the paths whose shapes each kernel's rows come from
PATHS = {"enhance_lines_fused": ("batch",), "fused_layernorm": ("trunk-ln",),
         "fused_add_layernorm": ("trunk-ln",), "flash_attn_lse": ("train", "train-t"),
         "flash_attn_bwd_dq": ("train", "train-t"), "flash_attn_bwd_dkv": ("train", "train-t")}


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_rows: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    tree = None
    if args[:1] == ["--tree"]:
        tree = Path(args[1]).resolve()
        args = args[2:]
        # the package resolves to OTHER_TREE's from here on (chip_smoke
        # imports it inside its functions)
        sys.path.insert(0, str(tree))
    only = None
    if args[:1] == ["--path"]:
        only, args = args[1], args[2:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the plain refinement's convolutions
    keep = set(args) or {"flash_attn", "mlp_block"}
    cases = chip_smoke.kernel_cases
    chip_smoke.kernel_cases = lambda torch, path, rc=None: [
        c for c in cases(torch, path, rc) if c[0] in keep]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"tree": str(tree or REPO), "card": smi}), flush=True)
    fields = ("ms", "eager_ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")
    paths = sorted({p for k in keep for p in PATHS.get(k, ("l@1024", "t@512"))
                    if only in (None, p)})
    for path in paths:
        summary = chip_smoke.run_kernels(torch, path, ({}, {}) if path == "batch" else None)
        print(json.dumps({path: {k: {**{f: v[f] for f in fields},
                                         **({"f32": v["f32"]} if "f32" in v else {})}
                                 for k, v in summary.items()}}), flush=True)
    if tree is None:
        chip_smoke.launch_floor(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
