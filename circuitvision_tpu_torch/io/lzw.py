"""ctypes bindings of native/lzw.cpp (g++ at first use): GIF's and TIFF's
LZW and PackBits, the byte-stream decoders of io/gif.py and io/tiff.py."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from ..core.native import build_library

_SRC = Path(__file__).resolve().parent / "native" / "lzw.cpp"
_SIZE = ctypes.POINTER(ctypes.c_size_t)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    lib = build_library(_SRC, "cvlzw")
    lib.cv_gif_lzw.restype = ctypes.c_int
    lib.cv_gif_lzw.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_size_t, _SIZE, ctypes.POINTER(ctypes.c_int),
                               ctypes.c_char_p, ctypes.c_int]
    lib.cv_tiff_lzw.restype = ctypes.c_int
    lib.cv_tiff_lzw.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                ctypes.c_size_t, _SIZE, ctypes.c_char_p, ctypes.c_int]
    lib.cv_packbits.restype = ctypes.c_int
    lib.cv_packbits.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                ctypes.c_size_t, _SIZE, _SIZE]
    return lib


def gif_lzw(data: bytes, min_bits: int, pixels: int) -> tuple[np.ndarray, bool]:
    """Up to `pixels` indices of a GIF image's LZW stream (its sub-blocks
    joined) and whether the end code was met. Raises ValueError naming a
    broken stream."""
    out = np.zeros(pixels, np.uint8)
    written, ended = ctypes.c_size_t(), ctypes.c_int()
    err = ctypes.create_string_buffer(128)
    if load_library().cv_gif_lzw(data, len(data), min_bits, out.ctypes.data, pixels,
                                 ctypes.byref(written), ctypes.byref(ended), err, len(err)):
        raise ValueError(err.value.decode())
    return out[:written.value], bool(ended.value)


def tiff_lzw(data: bytes, size: int) -> bytes:
    """Up to `size` bytes of a TIFF LZW strip or tile."""
    out = np.zeros(size, np.uint8)
    written = ctypes.c_size_t()
    err = ctypes.create_string_buffer(128)
    if load_library().cv_tiff_lzw(data, len(data), out.ctypes.data, size, ctypes.byref(written),
                                  err, len(err)):
        raise ValueError(err.value.decode())
    return out[:written.value].tobytes()


def packbits(data: bytes, size: int) -> bytes:
    """Up to `size` bytes of a PackBits strip or tile."""
    out = np.zeros(size, np.uint8)
    written, consumed = ctypes.c_size_t(), ctypes.c_size_t()
    load_library().cv_packbits(data, len(data), out.ctypes.data, size, ctypes.byref(written),
                               ctypes.byref(consumed))
    return out[:written.value].tobytes()
