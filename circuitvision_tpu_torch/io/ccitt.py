"""ctypes binding of native/ccitt.cpp (g++ at first use): the CCITT T.4
and T.6 strips of io/tiff.py."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from ..core.native import build_library

_SRC = Path(__file__).resolve().parent / "native" / "ccitt.cpp"


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    lib = build_library(_SRC, "cvccitt")
    lib.cv_ccitt_decode.restype = ctypes.c_int
    lib.cv_ccitt_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def decode_ccitt(data: bytes, scheme: int, t4_options: int, width: int, rows: int) -> bytes:
    """`rows` packed rows (MSB first, a coded black pixel 1) of one strip
    of TIFF compression 2, 3 or 4. Raises ValueError at a code the
    tables do not hold."""
    out = np.zeros((rows, (width + 7) // 8), np.uint8)
    got = load_library().cv_ccitt_decode(data, len(data), scheme, t4_options, width, rows,
                                         out.ctypes.data)
    if got < rows:
        raise ValueError(f"no valid code in row {got} of {rows}")
    return out.tobytes()
