"""ctypes bindings of native/lzw.cpp (g++ at first use): GIF's and TIFF's
LZW, PackBits and PCX's run lengths, the byte-stream decoders of
io/gif.py, io/tiff.py and io/pcx.py."""
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
    lib.cv_pcx_rle.restype = ctypes.c_int
    lib.cv_pcx_rle.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int]
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


def packbits_rows(data: bytes, row: int, rows: int) -> np.ndarray:
    """(rows, row) bytes of a PackBits stream decoded a row at a time, as
    Pillow's PackbitsDecode does: a packet that runs past a row's end is
    cut there, whole as it was read. Raises ValueError where it ends early."""
    out = np.zeros((rows, row), np.uint8)
    lib = load_library()
    written, consumed = ctypes.c_size_t(), ctypes.c_size_t()
    at = 0
    for y in range(rows):  # a row's packets take at most row + row / 128 + 1 bytes
        lib.cv_packbits(data[at:at + 2 * row + 256], min(len(data) - at, 2 * row + 256),
                        out[y].ctypes.data, row, ctypes.byref(written), ctypes.byref(consumed))
        if written.value < row:
            raise ValueError(f"image file is truncated ({y} of {rows} rows)")
        at += consumed.value
    return out


def pcx_rle(data: bytes, line_bytes: int, lines: int) -> np.ndarray:
    """(lines, line_bytes) of a PCX image's run-length data. Raises
    ValueError where the data ends early or a run crosses a line's end."""
    out = np.zeros((lines, line_bytes), np.uint8)
    got = load_library().cv_pcx_rle(data, len(data), out.ctypes.data, line_bytes, lines)
    if got < 0:
        raise ValueError("a run reaches past the end of a line")
    if got < lines:
        raise ValueError(f"image file is truncated ({got} of {lines} lines)")
    return out
