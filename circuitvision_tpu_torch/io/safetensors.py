"""A reader of the safetensors format over numpy, for the PaliGemma
converter (`models/checkpoint.convert_paligemma_checkpoint`); the card's
machine has no `safetensors` package.

A file is an 8-byte little-endian header length N, N bytes of JSON —
{name: {"dtype", "shape", "data_offsets": [begin, end]}, and an optional
"__metadata__" of strings} — then the raw little-endian tensor bytes,
offsets counted from the end of the header. The file is read with one
read into a writable buffer, and each tensor is a numpy view of it.

The dtypes numpy has are read as they are. BF16, which numpy has no
type for, is widened to float32 with no loss (its 16 bits are the high
half of a float32), the dtype the orbax writer takes; the JAX package's
converter keeps such a tensor in ml_dtypes' bfloat16, with the same
values. Other dtypes (the float8 types) are refused with an error
naming the dtype and the file.
"""
from __future__ import annotations

import json
import math
import os
import struct

import numpy as np

#: safetensors dtype name → little-endian numpy dtype (BF16: its raw bits,
#: widened to float32 by `load_file`)
DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2",
    "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
    "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1",
    "BOOL": "?", "BF16": "<u2",
}


class SafetensorsFormatError(ValueError):
    """A file this reader does not take, and why."""


def load_file(path: str) -> dict[str, np.ndarray]:
    """Every tensor of the safetensors file at `path`, by name, as numpy
    arrays (views of one buffer holding the file)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        buf = bytearray(size)
        if f.readinto(buf) != size:
            raise SafetensorsFormatError(f"{path}: short read")
    if size < 8:
        raise SafetensorsFormatError(f"{path}: {size} bytes, no header")
    (n,) = struct.unpack_from("<Q", buf, 0)
    if n > size - 8:
        raise SafetensorsFormatError(f"{path}: header of {n} bytes in a file of {size}")
    try:
        header = json.loads(bytes(buf[8:8 + n]))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise SafetensorsFormatError(f"{path}: header is not JSON: {exc}") from exc
    if not isinstance(header, dict):
        raise SafetensorsFormatError(f"{path}: header is not a JSON object")
    data = memoryview(buf)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = info.get("dtype")
        if dtype not in DTYPES:
            raise SafetensorsFormatError(f"{path}: tensor {name!r} has dtype {dtype!r}, "
                                         f"which this reader does not take")
        dt = np.dtype(DTYPES[dtype])
        shape = tuple(int(d) for d in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        if not 0 <= begin <= end <= len(data) or end - begin != math.prod(shape) * dt.itemsize:
            raise SafetensorsFormatError(f"{path}: tensor {name!r} {dtype}{list(shape)} at "
                                         f"bytes [{begin}, {end}) of {len(data)}")
        arr = np.frombuffer(data[begin:end], dt).reshape(shape)
        out[name] = (arr.astype("<u4") << 16).view("<f4") if dtype == "BF16" else arr
    return out
