#!/usr/bin/env python3
"""chip_smoke.py's kernel phases alone, for the kernels named.

    python3 scripts/kernel_rows.py [kernel ...]   (default: flash_attn mlp_block)

Runs `chip_smoke.run_kernels` at every L@1024 and t@512 shape of the named
kernels — each against its plain version on the card, in bfloat16 and
float32, with times, bound and library time — and prints chip_smoke.py's
per-shape JSON rows, then per path the sums over one analyze()'s launches
(bfloat16). It builds only what those kernels need, so a kernel change
can be measured without the whole smoke run. Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_rows: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    keep = set(sys.argv[1:]) or {"flash_attn", "mlp_block"}
    cases = chip_smoke.kernel_cases
    chip_smoke.kernel_cases = lambda torch, path, rc=None: [
        c for c in cases(torch, path, rc) if c[0] in keep]
    fields = ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")
    for path in ("l@1024", "t@512"):
        summary = chip_smoke.run_kernels(torch, path)
        print(json.dumps({path: {k: {f: v[f] for f in fields} for k, v in summary.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
