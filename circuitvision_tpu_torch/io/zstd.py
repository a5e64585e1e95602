"""zstd frame decoding through the system's libzstd, bound with ctypes.

The orbax checkpoints compress twice with zstd: OCDBT compresses its
manifests and b-tree nodes, and every zarr chunk names the zstd
compressor (models/checkpoint.py). About 164 MB of the three shipped
checkpoints sit in compressed blocks, far too much for a decoder in
Python. The machines the port runs on carry the system libzstd.so.1
(1.5.5 beside the H100), so the port decodes through it and has no
other path: without the library, `decompress` raises and names it.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

#: output bytes drawn at a time
_STEP = 1 << 20


class ZstdError(RuntimeError):
    """libzstd is missing, or a frame does not decode."""


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The system libzstd, its functions typed."""
    path = ctypes.util.find_library("zstd")
    if path is None:
        raise ZstdError("libzstd (libzstd.so.1) is not installed; the checkpoint reader "
                        "decodes zstd frames through it")
    lib = ctypes.CDLL(path)
    size_t, ptr = ctypes.c_size_t, ctypes.c_void_p
    lib.ZSTD_createDCtx.restype = ptr
    lib.ZSTD_createDCtx.argtypes = []
    lib.ZSTD_freeDCtx.restype = size_t
    lib.ZSTD_freeDCtx.argtypes = [ptr]
    lib.ZSTD_decompressStream.restype = size_t
    lib.ZSTD_decompressStream.argtypes = [ptr, ctypes.POINTER(_OutBuffer),
                                          ctypes.POINTER(_InBuffer)]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [size_t]
    lib.ZSTD_versionNumber.restype = ctypes.c_uint
    lib.ZSTD_versionNumber.argtypes = []
    return lib


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ZstdError(f"zstd: {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def decompress(data: bytes) -> bytes:
    """The content of one zstd frame, streamed into output drawn _STEP
    bytes at a time: one path for the frames that state their content
    size (the zarr chunks) and those that do not (OCDBT's nodes)."""
    lib = library()
    data = bytes(data)
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise ZstdError("zstd: ZSTD_createDCtx failed")
    try:
        src = ctypes.create_string_buffer(data, len(data))
        inb = _InBuffer(ctypes.addressof(src), len(data), 0)
        chunks = []
        left = 1
        while left:
            out = ctypes.create_string_buffer(_STEP)
            outb = _OutBuffer(ctypes.addressof(out), _STEP, 0)
            left = _check(lib, lib.ZSTD_decompressStream(dctx, ctypes.byref(outb),
                                                         ctypes.byref(inb)), "decompress")
            chunks.append(out.raw[:outb.pos])
            if left and inb.pos == inb.size and outb.pos < outb.size:
                raise ZstdError("zstd: the frame is truncated")
        if inb.pos != inb.size:
            raise ZstdError(f"zstd: {inb.size - inb.pos} bytes follow the frame")
        return b"".join(chunks)
    finally:
        lib.ZSTD_freeDCtx(dctx)
