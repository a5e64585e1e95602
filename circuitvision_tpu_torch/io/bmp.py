"""BMP decoding in numpy, as Pillow 12.1.0's BmpImagePlugin reads a file,
then convert("RGB").

  * headers: OS/2 1.x (12 bytes, 16-bit sizes, 3-byte palette entries)
    and BITMAPINFOHEADER through V5 (40, 52, 56, 64, 108, 124 bytes);
    a height whose top byte is 0xFF is a top-down image of 2**32 -
    height rows;
  * 1-, 4- and 8-bit palettes; a palette whose entries are all grey
    ramps ((0, 255) for two colours, entry i = (i, i, i) otherwise) is
    dropped and the samples read as grey, at 8 bits a sample whatever
    the depth (PIL's "1"/"L" raw modes); indices past the palette are
    black;
  * 16-bit 5-5-5 and 24-bit pixels, 32-bit BI_RGB read as BGRX;
  * BI_BITFIELDS with the masks PIL lists (16: 5-6-5 and 5-5-5; 24:
    BGR; 32: eight layouts); any other mask raises;
  * RLE8 and RLE4 as PIL's BmpRleDecoder runs them, quirks kept: a delta
    escape reads two bytes it drops and then the two it uses, an odd
    RLE4 absolute run loses its last pixel, absolute runs may spill
    into the next row, word alignment follows the position in the file,
    and a stream that ends short raises "not enough image data";
  * compressions 4 and 5 (JPEG or PNG inside) and other depths raise.

A file PIL cannot read raises `ImageFormatError` naming the reason.
"""
from __future__ import annotations

import struct

import numpy as np

#: header sizes Pillow reads (BmpImagePlugin._bitmap)
_HEADERS = (12, 40, 52, 56, 64, 108, 124)
#: PIL's Image.MAX_IMAGE_PIXELS; twice it raises DecompressionBombError
_MAX_PIXELS = 2 * int(1024 * 1024 * 1024 // 4 // 3)
_BITFIELDS = {
    32: ((0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
         (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
         (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)),
    24: ((0xFF0000, 0xFF00, 0xFF),),
    16: ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)),
}


def _error(msg: str) -> Exception:
    from .image_io import ImageFormatError
    return ImageFormatError(f"BMP: {msg}")


def _header(data: bytes) -> dict:
    """The fields PIL's _bitmap reads, the file position after them, and
    where the pixels start."""
    if len(data) < 18:
        raise _error("truncated header")
    offset = struct.unpack_from("<I", data, 10)[0]
    size = struct.unpack_from("<I", data, 14)[0]
    if size not in _HEADERS:
        raise _error(f"unsupported header type ({size})")
    body = data[18:14 + size]
    if len(body) < size - 4:
        raise _error("truncated header")
    pos = 14 + size
    f = {"header_size": size, "masks": None}
    if size == 12:
        f["width"], f["height"], _planes, f["bits"] = struct.unpack_from("<HHHH", body)
        f.update(compression=0, colors=0, padding=3, top_down=False)
    else:
        f["top_down"] = body[7] == 0xFF
        w, h, _planes, f["bits"], f["compression"] = struct.unpack_from("<IIHHI", body)
        f["width"], f["height"] = w, (2 ** 32 - h if f["top_down"] else h)
        f["colors"] = struct.unpack_from("<I", body, 28)[0]
        f["padding"] = 4
        if f["compression"] == 3:
            if len(body) >= 48:
                n = 4 if len(body) >= 52 else 3
                masks = struct.unpack_from(f"<{n}I", body, 36)
            else:
                masks = struct.unpack_from("<3I", data[pos:pos + 12].ljust(12, b"\x00"))
                if len(data) < pos + 12:
                    raise _error("truncated bitfield masks")
                pos += 12
            f["masks"] = tuple(masks) + (0,) * (4 - len(masks))
    f["colors"] = f["colors"] or (1 << f["bits"] if f["bits"] < 64 else 0)
    if offset == 14 + size and f["bits"] <= 8:
        offset += 4 * f["colors"]
    f["offset"], f["pos"] = offset, pos
    return f


def _raw_layout(f: dict) -> str:
    """PIL's raw mode for the pixel data, checking what it refuses."""
    bits, comp = f["bits"], f["compression"]
    if bits not in (1, 4, 8, 16, 24, 32):
        raise _error(f"unsupported pixel depth ({bits})")
    if comp == 3:
        masks = f["masks"]
        key = masks if bits == 32 else masks[:3]
        if key not in _BITFIELDS.get(bits, ()):
            raise _error(f"unsupported bitfields layout {tuple(hex(m) for m in key)} at "
                         f"{bits} bits")
        return "bitfields"
    if comp in (1, 2):
        return "rle"
    if comp != 0:
        what = {4: " (JPEG inside)", 5: " (PNG inside)"}.get(comp, "")
        raise _error(f"unsupported compression ({comp}){what}")
    return "raw"


def _palette(data: bytes, f: dict):
    """(mode, lut): "1" or "L" for PIL's grey palettes, else "P" with a
    256-entry RGB table, black past the file's entries."""
    colors, pad = f["colors"], f["padding"]
    if not 0 < colors <= 65536:
        raise _error(f"unsupported palette size ({colors})")
    raw = data[f["pos"]:f["pos"] + pad * colors]
    f["pos"] += len(raw)
    indices = (0, 255) if colors == 2 else range(colors)
    if all(raw[i * pad:i * pad + 3] == bytes([v & 255]) * 3 for i, v in enumerate(indices)):
        return ("1" if colors == 2 else "L"), None
    n = len(raw) // pad
    entries = np.frombuffer(raw[:n * pad], np.uint8).reshape(n, pad)[:256, 2::-1]
    lut = np.zeros((256, 3), np.uint8)
    lut[:len(entries)] = entries
    return "P", lut


def _rows(data: bytes, start: int, stride: int, h: int) -> np.ndarray:
    need = stride * h
    if len(data) < start + need:
        raise _error(f"image file is truncated ({max(0, len(data) - start)} bytes of pixel "
                     f"data, {need} expected)")
    return np.frombuffer(data, np.uint8, need, start).reshape(h, stride)


def _rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> bytes:
    """PIL's BmpRleDecoder.decode: the pixels (one byte each) in file row
    order."""
    out = bytearray()
    x, n, dest = 0, len(data), w * h
    while len(out) < dest:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                pair = bytes((byte >> 4, byte & 15))
                out += pair * (count // 2) + pair[:count & 1]
            else:
                out += bytes((byte,)) * count
            x += count
        elif byte == 0:  # end of line
            if len(out) % w:
                out += bytes(w - len(out) % w)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: PIL reads two bytes, drops them, reads two more
            if pos + 2 > n:
                break
            pos += 2
            if pos + 2 > n:
                raise _error("RLE delta runs past the end of the file")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:  # absolute run
            want = byte // 2 if rle4 else byte
            got = data[pos:pos + want]
            pos += len(got)
            if rle4:
                a = np.frombuffer(got, np.uint8)
                out += np.stack([a >> 4, a & 15], axis=1).tobytes()
            else:
                out += got
            if len(got) < want:
                break
            x += byte
            if pos % 2:
                pos += 1
    if len(out) < dest:
        raise _error("not enough image data (the RLE stream ends short)")
    return bytes(out[:dest])


def decode_dib(data: bytes, pos: int) -> np.ndarray:
    """The device-independent bitmap at `pos` of an icon or cursor file
    (no file header) as PIL's DibImageFile reads it there for
    IcoImagePlugin and CurImagePlugin: the pixels start after the info
    header, its bitfield masks and its palette, and the image is the lower
    half of the stored height (the upper half is the AND mask, which
    convert("RGB") never shows). (H, W, 3) uint8 RGB."""
    if len(data) < pos + 16:
        raise _error("truncated header")
    size = struct.unpack_from("<I", data, pos)[0]
    if size not in _HEADERS:
        raise _error(f"unsupported header type ({size})")
    if size == 12:
        bits, colors, comp, pad = struct.unpack_from("<H", data, pos + 10)[0], 0, 0, 3
    else:
        bits, comp = struct.unpack_from("<HI", data, pos + 14)
        colors, pad = (struct.unpack_from("<I", data, pos + 32)[0]
                       if len(data) >= pos + 36 else 0), 4
    start = size + (12 if comp == 3 and size == 40 else 0)
    if bits <= 8:
        start += pad * (colors or 1 << bits)
    bmp = b"BM" + struct.pack("<IHHI", 0, 0, 0, 14 + start) + data[pos:]
    return decode_bmp(bmp, halve=True)


def decode_bmp(data: bytes, halve: bool = False) -> np.ndarray:
    """BMP bytes → (H, W, 3) uint8 RGB as PIL's convert("RGB") gives it;
    with `halve`, the lower half of the stored rows, as PIL reads an icon's
    bitmap."""
    f = _header(data)
    w, h, bits = f["width"], f["height"], f["bits"]
    layout = _raw_layout(f)
    if w == 0 or h == 0:
        raise _error(f"image has no pixels ({w} x {h})")
    if w * h > _MAX_PIXELS:
        raise _error(f"{w} x {h} pixels is over PIL's decompression-bomb limit")
    start = f["offset"] or f["pos"]
    stride = ((w * bits + 31) >> 3) & ~3
    if halve:
        h = f["height"] = h // 2
    if bits > 8:
        if layout == "rle":
            raise _error(f"RLE compression at {bits} bits (PIL has no P to RGB raw mode)")
        rgb = _direct(_rows(data, start, stride, h), w, bits,
                      f["masks"] if layout == "bitfields" else None)
    else:
        mode, lut = _palette(data, f)
        if layout == "rle":
            if mode == "1":
                raise _error("an RLE image with a black-and-white palette (PIL has no P to 1 "
                             "raw mode)")
            idx = np.frombuffer(_rle(data, start, w, h, f["compression"] == 2),
                                np.uint8).reshape(h, w)
        else:
            idx = _indices(_rows(data, start, stride, h), w, bits, mode)
        rgb = lut[idx] if mode == "P" else np.repeat(idx[:, :, None], 3, axis=2)
    if not f["top_down"]:
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)


def _indices(rows: np.ndarray, w: int, bits: int, mode: str) -> np.ndarray:
    """(h, w) samples of 1-, 4- and 8-bit rows: palette indices, or grey
    levels where PIL dropped a grey palette ("1": a bit a sample scaled
    to 255; "L": a byte a sample, whatever the depth)."""
    h, stride = rows.shape
    if mode in ("1", "L") and stride < ((w + 7) // 8 if mode == "1" else w):
        raise _error(f"a grey palette at {bits} bits is read 8 bits a sample, which the rows "
                     f"do not hold")
    if mode == "1":
        return np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
    if mode == "L" or bits == 8:
        return rows[:, :w]
    idx = np.unpackbits(rows, axis=1).reshape(h, -1, bits)[:, :w]
    return (idx * (1 << np.arange(bits - 1, -1, -1))).sum(-1).astype(np.uint8)


def _direct(rows: np.ndarray, w: int, bits: int, masks) -> np.ndarray:
    """RGB of 16-, 24- and 32-bit rows: the byte each mask names (BI_RGB
    32-bit is BGRX), 16-bit values scaled by PIL's v * 255 // max."""
    h = rows.shape[0]
    if bits == 16:
        v = rows[:, :2 * w].view("<u2").astype(np.uint32)
        if masks is not None and masks[:3] == (0xF800, 0x7E0, 0x1F):
            r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
            return np.stack([r * 255 // 31, g * 255 // 63, b * 255 // 31],
                            axis=-1).astype(np.uint8)
        r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
        return (np.stack([r, g, b], axis=-1) * 255 // 31).astype(np.uint8)
    step = bits // 8
    px = rows[:, :step * w].reshape(h, w, step)
    if bits == 24 or masks is None or masks == (0, 0, 0, 0):
        return px[:, :, 2::-1] if step == 3 else px[:, :, [2, 1, 0]]
    at = [m.bit_length() // 8 - 1 for m in masks[:3]]
    return px[:, :, at]
