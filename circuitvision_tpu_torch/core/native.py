"""Build and load the port's host-side C++ sources.

Each source is compiled with g++ into the package's git-ignored build/
directory at first use, under a name that hashes the source and the
flags, and loaded with ctypes. A build that fails raises: the port has
no slower path that would hide it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()


def build_library(src: Path, stem: str) -> ctypes.CDLL:
    """g++ `src` into build/lib<stem>-<hash>.so unless it is there, and
    load it. The caller types the functions."""
    with _lock:
        digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode())
        path = BUILD_DIR / f"lib{stem}-{digest.hexdigest()[:16]}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", str(tmp)], check=True,
                           capture_output=True)
            os.replace(tmp, path)
        return ctypes.CDLL(str(path))
