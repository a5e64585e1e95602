#!/usr/bin/env python3
"""Compare the machine code of the port's CUDA kernels between two trees.

    python3 scripts/sass_compare.py OTHER_TREE [source ...]
    python3 scripts/sass_compare.py --opcodes source [function-substring]

Compiles each `circuitvision_tpu_torch/csrc/<source>.cu` of this tree and
of OTHER_TREE (another checkout of the repository) for sm_90a with the
build's own flags into a cubin, disassembles both with `cuobjdump -sass`,
and prints one JSON line per kernel function found in either: whether
its SASS is identical once the anonymous-namespace hash in symbol names
is taken out, and how many instruction lines differ. Functions are
matched by their demangled names up to the parameter list, without the
template arguments that hold nothing and stand for a default
(IGNORED_ARGS), so a kernel given such a parameter is compared with its
former self. With --opcodes it prints, for each kernel function of this
tree's csrc/<source>.cu whose name holds the substring, how many
instructions of each opcode its SASS has (static counts: a loop body
counts once). Default sources: mlp_block global_attn window_attn. Needs
nvcc and cuobjdump (the CUDA toolkit); no card.
"""
from __future__ import annotations

import difflib
import json
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from circuitvision_tpu_torch.ops.cuda.build import NVCC_FLAGS, _nvcc  # noqa: E402

#: `_GLOBAL__N__<hash>` names the anonymous namespace per translation unit
ANON = re.compile(r"_GLOBAL__N__[0-9a-f_]+")
#: template arguments taken out of the names: tc_gemm.cuh's default A layout
IGNORED_ARGS = re.compile(r",\s*(?:<unnamed>::|\(anonymous namespace\)::)?(?:\w+::)*RowMajorA\b")


def demangled(names: list[str]) -> list[str]:
    out = subprocess.run([str(Path(_nvcc()).parent / "cu++filt")], input="\n".join(names),
                         check=True, capture_output=True, text=True).stdout.splitlines()
    return [IGNORED_ARGS.sub("", re.sub(r"\([^()]*\)$", "", n)) for n in out]


def sass(tree: Path, source: str, out: Path) -> dict[str, list[str]]:
    """Per-function SASS lines of csrc/<source>.cu in `tree`, addresses,
    encodings and the namespace hash taken out."""
    cubin = out / f"{source}.cubin"
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_nvcc(), *flags, "-cubin", "-o", str(cubin),
                    str(tree / "circuitvision_tpu_torch" / "csrc" / f"{source}.cu")], check=True)
    text = subprocess.run([str(Path(_nvcc()).parent / "cuobjdump"), "-sass", str(cubin)],
                          check=True, capture_output=True, text=True).stdout
    funcs: dict[str, list[str]] = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and "/*" in line:
            instr = re.sub(r"/\*[0-9a-f]+\*/", "", line.split(";")[0]).strip()
            if instr and not instr.startswith("/*"):
                funcs[name].append(ANON.sub("ANON", instr))
    names = list(funcs)
    return {key: funcs[n] for n, key in zip(names, demangled(names))}


def opcodes(source: str, part: str) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        for fn, lines in sass(REPO, source, Path(tmp)).items():
            if part in fn:
                counts = Counter(re.sub(r"^@!?U?P\w+\s+", "", ln).split()[0].split(".")[0]
                                 for ln in lines)
                print(json.dumps({"source": source, "function": fn, "instructions": len(lines),
                                  "opcodes": dict(counts.most_common())}), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--opcodes"] and len(sys.argv) > 2:
        opcodes(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else "")
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    sources = sys.argv[2:] or ["mlp_block", "global_attn", "window_attn"]
    with tempfile.TemporaryDirectory() as tmp:
        for source in sources:
            a_dir, b_dir = Path(tmp, "this"), Path(tmp, "other")
            a_dir.mkdir(exist_ok=True)
            b_dir.mkdir(exist_ok=True)
            mine, theirs = sass(REPO, source, a_dir), sass(other, source, b_dir)
            for fn in sorted(set(mine) | set(theirs)):
                a, b = mine.get(fn), theirs.get(fn)
                row = {"source": source, "function": fn, "in_this": a is not None,
                       "in_other": b is not None}
                if a is not None and b is not None:
                    diff = [d for d in difflib.unified_diff(b, a, lineterm="", n=0)
                            if d[:1] in "+-" and d[:3] not in ("+++", "---")]
                    row.update(identical=a == b, instructions=[len(a), len(b)],
                               lines_differing=len(diff))
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
