"""PSD decoding as Pillow 12.1.0's PsdImagePlugin reads a file — the
merged image after the header, the colour mode data, the image resources
and the layer and mask information — then convert("RGB").

  * 8-bit grey, multichannel and duotone (the first channel as grey), RGB
    (RGBA where there are exactly 4 channels; alpha dropped), CMYK (the
    stored channels are 255 − ink, Pillow's "C;I" … unpackers) and
    indexed (the 768-byte colour table, reds then greens then blues; with
    no such table, black, as PIL converts a palette image without one),
    and 1-bit bitmaps (a set bit is white, Pillow's raw "1");
  * raw planes and PackBits rows (decoded a row at a time, a packet cut at
    a row's end, io/lzw.packbits_rows), each channel read from where the
    row byte counts of the channels Pillow takes put it (past the end of
    the count table when the file has more channels, as in Pillow).

Lab, 16- and 32-bit files and the ZIP compressions raise
`ImageFormatError` naming them.
"""
from __future__ import annotations

import struct

import numpy as np

from .lzw import packbits_rows

_MAX_PIXELS = 2 * int(1024 * 1024 * 1024 // 4 // 3)
#: (Photoshop mode, bits) → (Pillow's mode, channels it reads)
_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
          (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1)}


def _error(msg: str) -> Exception:
    from .image_io import ImageFormatError
    return ImageFormatError(f"PSD: {msg}")


def decode_psd(data: bytes) -> np.ndarray:
    """PSD bytes → (H, W, 3) uint8 RGB of the merged image."""
    if len(data) < 26 or data[:4] != b"8BPS" or struct.unpack_from(">H", data, 4)[0] != 1:
        raise _error("not a PSD file")
    n_ch, h, w, bits, ps_mode = struct.unpack_from(">HIIHH", data, 12)
    if (ps_mode, bits) == (9, 8):
        raise _error("Lab files are not read")
    if (ps_mode, bits) not in _MODES:
        raise _error(f"colour mode {ps_mode} at {bits} bits is not read")
    mode, channels = _MODES[(ps_mode, bits)]
    if channels > n_ch:
        raise _error("not enough channels")
    if mode == "RGB" and n_ch == 4:
        channels = 4
    if w * h > _MAX_PIXELS:
        raise _error(f"{w} x {h} pixels is over PIL's decompression-bomb limit")
    pos = 26
    try:
        (size,) = struct.unpack_from(">I", data, pos)
        table = data[pos + 4:pos + 4 + size]
        pos += 4 + size
        for _section in ("image resources", "layer and mask information"):
            (size,) = struct.unpack_from(">I", data, pos)
            pos += 4 + size
        (compression,) = struct.unpack_from(">H", data, pos)
    except struct.error:
        raise _error("truncated before the image data") from None
    pos += 2
    row = (w + 7) // 8 if mode == "1" else w
    planes = []
    if compression == 0:
        for _c in range(channels):
            raw = data[pos:pos + row * h]
            if len(raw) < row * h:
                raise _error("image file is truncated")
            planes.append(np.frombuffer(raw, np.uint8).reshape(h, row))
            pos += w * h
    elif compression == 1:
        # Pillow reads the counts of the channels it takes, and the data
        # from there, however many channels the file has
        counts = np.frombuffer(data[pos:pos + 2 * channels * h], ">u2").astype(np.int64)
        if len(counts) < channels * h:
            raise _error("truncated row byte counts")
        pos += 2 * channels * h
        for c in range(channels):
            try:
                planes.append(packbits_rows(data[pos:], row, h))
            except ValueError as exc:
                raise _error(str(exc)) from None
            pos += int(counts[c * h:(c + 1) * h].sum())
    else:
        raise _error(f"compression {compression} (ZIP) is not read")
    if mode == "1":
        bit = np.unpackbits(planes[0], axis=1)[:, :w]
        return np.repeat((bit * 255).astype(np.uint8)[:, :, None], 3, axis=2)
    if mode == "L":
        return np.repeat(planes[0][:, :, None], 3, axis=2)
    if mode == "P":
        if len(table) != 768:
            return np.zeros((h, w, 3), np.uint8)
        return np.frombuffer(table, np.uint8).reshape(3, 256).T[planes[0]]
    if mode == "CMYK":
        from .image_io import cmyk_to_rgb
        return cmyk_to_rgb(np.stack(planes, axis=2))
    return np.stack(planes[:3], axis=2)
