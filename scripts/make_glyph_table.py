#!/usr/bin/env python3
"""Write circuitvision_tpu_torch/core/hershey.py, the port's table of
cv2's FONT_HERSHEY_SIMPLEX glyphs, from cv2.putText renders.

    python scripts/make_glyph_table.py

Needs cv2 (this script only). OpenCV 5.0.0's putText draws the Hershey
font faces through its TrueType engine: each glyph is an antialiased
coverage map (whatever the line type), blended into the image glyph by
glyph as (dst·(255 − a) + colour·a + 127) // 255, at integer advances
with no kerning. So a glyph is recovered whole from one render: white on
black at a known origin gives its coverage a as the pixel values, its
offset from the origin and, from a render of the glyph followed by '|',
its advance. The table holds every printable ASCII glyph at the (scale,
thickness) pairs the port draws with (core/viz.py): 0.5 and 1, 0.5 and
2, 0.9 and 2; getTextSize's height per pair; and is checked here against
cv2 on every glyph pair before it is written.
"""
from __future__ import annotations

import base64
import zlib
from pathlib import Path

import cv2
import numpy as np

OUT = Path(__file__).resolve().parents[1] / "circuitvision_tpu_torch" / "core" / "hershey.py"
SIZES = ((0.5, 1), (0.5, 2), (0.9, 2))
CHARS = [chr(c) for c in range(32, 127)]
H, W, OX, OY = 120, 200, 40, 70
FONT = cv2.FONT_HERSHEY_SIMPLEX


def render(text, scale, thickness, org=(OX, OY)):
    img = np.zeros((H, W), np.uint8)
    cv2.putText(img, text, org, FONT, scale, 255, thickness)
    return img


def blend(img, glyph, x, y):
    dx, dy, a = glyph
    if a.size:
        sub = img[y + dy:y + dy + a.shape[0], x + dx:x + dx + a.shape[1]].astype(np.int32)
        img[y + dy:y + dy + a.shape[0], x + dx:x + dx + a.shape[1]] = (
            (sub * (255 - a.astype(np.int32)) + 255 * a.astype(np.int32) + 127) // 255)


def table(scale, thickness):
    glyphs, advances = {}, {}
    for c in CHARS:
        img = render(c, scale, thickness)
        ys, xs = np.nonzero(img)
        glyphs[c] = ((int(xs.min()) - OX, int(ys.min()) - OY,
                      img[ys.min():ys.max() + 1, xs.min():xs.max() + 1].copy())
                     if len(ys) else (0, 0, np.zeros((0, 0), np.uint8)))
    for c in CHARS:
        want, base = render(c + "|", scale, thickness), render(c, scale, thickness)
        for d in range(64):
            got = base.copy()
            blend(got, glyphs["|"], OX + d, OY)
            if (got == want).all():
                advances[c] = d
                break
        else:
            raise SystemExit(f"no advance found for {c!r} at {scale}/{thickness}")
    for a in CHARS:  # every pair: integer advances, no kerning
        base = render(a, scale, thickness)
        for b in CHARS:
            got = base.copy()
            blend(got, glyphs[b], OX + advances[a], OY)
            if not (got == render(a + b, scale, thickness)).all():
                raise SystemExit(f"pair {a + b!r} at {scale}/{thickness} is not two glyphs")
    height = cv2.getTextSize("A", FONT, scale, thickness)[0][1]
    blob = bytearray()
    for c in CHARS:
        dx, dy, a = glyphs[c]
        blob += np.array([advances[c], dx, dy, a.shape[0], a.shape[1]], np.int8).tobytes()
        blob += a.tobytes()
    return height, base64.b64encode(zlib.compress(bytes(blob), 9)).decode()


TEMPLATE = '''"""cv2's FONT_HERSHEY_SIMPLEX glyphs as OpenCV 5.0.0 draws them.

Written by scripts/make_glyph_table.py, which renders every glyph with
cv2.putText; do not edit. OpenCV 5.0.0 draws the Hershey font faces through its TrueType
engine, not as strokes: each printable ASCII glyph is an antialiased
coverage map (0-255) placed at an integer offset from the pen, and the
pen moves by an integer advance, with no kerning. `glyphs(scale,
thickness)` maps each character to (advance, dx, dy, coverage), dx and
dy the map's top-left corner relative to the pen on the baseline;
`TEXT_HEIGHT[(scale, thickness)]` is getTextSize's height. The tables
hold the sizes the port draws with (core/viz.py).
"""
from __future__ import annotations

import base64
import functools
import zlib

import numpy as np

FIRST, LAST = 32, 126
TEXT_HEIGHT = {height}
_DATA = {{
{data}}}


@functools.lru_cache(maxsize=None)
def glyphs(scale: float, thickness: int) -> dict:
    """{{char: (advance, dx, dy, coverage uint8 (h, w))}} at one size;
    KeyError for a size the table does not hold."""
    blob = zlib.decompress(base64.b64decode(_DATA[(scale, thickness)]))
    out, at = {{}}, 0
    for code in range(FIRST, LAST + 1):
        adv, dx, dy, h, w = np.frombuffer(blob[at:at + 5], np.int8).astype(int)
        h, w = h & 255, w & 255
        at += 5
        cov = np.frombuffer(blob[at:at + h * w], np.uint8).reshape(h, w)
        at += h * w
        out[chr(code)] = (int(adv), int(dx), int(dy), cov)
    return out
'''


def main() -> int:
    heights, data = {}, []
    for scale, thickness in SIZES:
        h, blob = table(scale, thickness)
        heights[(scale, thickness)] = h
        lines = "\n".join(f'        "{blob[i:i + 76]}"' for i in range(0, len(blob), 76))
        data.append(f"    ({scale}, {thickness}): (\n{lines}\n    ),\n")
    OUT.write_text(TEMPLATE.format(height=heights, data="".join(data)))
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
