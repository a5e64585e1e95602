#!/usr/bin/env python3
"""Write circuitvision_tpu_torch/core/rubik_digits.py, the outlines of the
digits "0"-"9" that cv2 5.0.0 draws for FONT_HERSHEY_SIMPLEX, from the
Rubik font inside the installed cv2 library.

    python scripts/make_digit_outlines.py [--check-only] [--max-rows N]

Needs cv2 and fontTools (this script only). OpenCV 5.0.0's putText draws
the Hershey font faces through its TrueType engine
(modules/imgproc/src/drawing_text.cpp) with the variable font Rubik, which
the library carries as a gzip member named Rubik.ttf; the script finds the
member by that name. What it found from cv2's renders, and checks before
it writes anything:

  * a (font scale, thickness) draws Rubik at a pixel size of
    round(scale / 0.037) and weight 400 for thickness 1, 600 for every
    thickness from 2 up (checked against cv2's own FontFace putText for
    thicknesses 1-120);
  * a weight's outline is the default (300) outline plus the gvar deltas
    at the avar-mapped coordinate, both rounded to F2Dot14, with untouched
    points interpolated, each coordinate floored to an integer; its
    advance the HVAR-varied width, floored;
  * pixels per font unit are size / 935 (the ascender) in float, and the
    pen moves by a glyph's advance rounded to 1/64 pixel and then floored
    to whole pixels.

The rasteriser itself is core/cpp/draw.cpp. The file written holds each
weight's outlines as stb_truetype vertex lists (implied on-curve points
resolved, in font units), the glyph header boxes the bitmap box is taken
from, and the advances. Before writing, the port's drawing of
"0123456789" (core/draw.put_text: a white halo at thickness + 2, then blue
digits, on white) is held to cv2's, byte for byte, with getTextSize, in
every render class of the enumeration image's sizes for images 1 to
--max-rows rows high (default 16384) and at the two heights on each side
of every class boundary, and for one digit at 32768 and 65500 rows.
"""
from __future__ import annotations

import argparse
import importlib.util
import io
import re
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
from fontTools.ttLib import TTFont
from fontTools.varLib.iup import iup_delta

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "circuitvision_tpu_torch" / "core" / "rubik_digits.py"
DIGITS = "0123456789"
FONT = cv2.FONT_HERSHEY_SIMPLEX
STEP = 0.037
WEIGHTS = (400, 600)


def rubik_bytes() -> bytes:
    """The Rubik.ttf gzip member of the cv2 library, inflated."""
    lib = next(Path(cv2.__file__).parent.glob("cv2*.so"))
    data = lib.read_bytes()
    for m in re.finditer(rb"\x1f\x8b\x08", data):
        at = m.start()
        if data[at + 3] & 8 and data[at + 10:at + 20] == b"Rubik.ttf\0":
            return zlib.decompressobj(16 + zlib.MAX_WBITS).decompress(data[at:])
    raise SystemExit(f"no gzip member named Rubik.ttf in {lib}")


def f2dot14(v: float) -> float:
    return round(v * 16384) / 16384


def normalized(font: TTFont, weight: float) -> float:
    """The wght coordinate, normalised, rounded and avar-mapped."""
    axis = next(a for a in font["fvar"].axes if a.axisTag == "wght")
    n = f2dot14((weight - axis.defaultValue) / (axis.maxValue - axis.defaultValue))
    seg = font["avar"].segments["wght"]
    keys = sorted(seg)
    for a, b in zip(keys, keys[1:]):
        if a <= n <= b:
            return f2dot14(seg[a] + (seg[b] - seg[a]) * (n - a) / (b - a))
    raise SystemExit(f"wght {weight} outside avar's map")


def scalar(n: float, start: float, peak: float, end: float) -> float:
    if peak == 0 or n == peak:
        return 1.0 if n == peak else 0.0
    if n <= start or n >= end:
        return 0.0
    return (n - start) / (peak - start) if n < peak else (end - n) / (end - peak)


def stb_vertices(points, on_curve, ends) -> list[tuple[int, int, int, int, int]]:
    """stbtt__GetGlyphShapeTT's vertex list (1 move, 2 line, 3 quadratic;
    x, y, cx, cy): implied on-curve points at the floored midpoints."""
    out = []

    def close(was_off, start_off, sx, sy, scx, scy, cx, cy):
        if start_off:
            if was_off:
                out.append((3, (cx + scx) >> 1, (cy + scy) >> 1, cx, cy))
            out.append((3, sx, sy, scx, scy))
        else:
            out.append((3, sx, sy, cx, cy) if was_off else (2, sx, sy, 0, 0))

    next_move = j = was_off = start_off = 0
    sx = sy = cx = cy = scx = scy = 0
    i = 0
    while i < len(points):
        x, y = points[i]
        if next_move == i:
            if i:
                close(was_off, start_off, sx, sy, scx, scy, cx, cy)
            start_off = not on_curve[i]
            if start_off:
                scx, scy = x, y
                if not on_curve[i + 1]:
                    sx, sy = (x + points[i + 1][0]) >> 1, (y + points[i + 1][1]) >> 1
                else:
                    (sx, sy), i = points[i + 1], i + 1
            else:
                sx, sy = x, y
            out.append((1, sx, sy, 0, 0))
            was_off, next_move, j = 0, 1 + ends[j], j + 1
        elif not on_curve[i]:
            if was_off:
                out.append((3, (cx + x) >> 1, (cy + y) >> 1, cx, cy))
            cx, cy, was_off = x, y, 1
        else:
            out.append((3, x, y, cx, cy) if was_off else (2, x, y, 0, 0))
            was_off = 0
        i += 1
    close(was_off, start_off, sx, sy, scx, scy, cx, cy)
    return out


def instance(font: TTFont, weight: int) -> tuple[int, dict]:
    """(advance, {digit: (header box, vertices)}) at a weight."""
    n = normalized(font, weight)
    cmap, glyf, gvar = font.getBestCmap(), font["glyf"], font["gvar"]
    hvar = font["HVAR"].table
    advances, out = set(), {}
    for d in DIGITS:
        name = cmap[ord(d)]
        g = glyf[name]
        pts = [tuple(map(float, p)) for p in g.coordinates]
        ends = list(g.endPtsOfContours)
        total = np.zeros((len(pts), 2))
        for tv in gvar.variations.get(name, []):
            s = scalar(n, *tv.axes["wght"])
            if s:
                deltas = tv.coordinates[:len(pts)]
                if any(c is None for c in deltas):
                    deltas = iup_delta(deltas, pts, ends)
                total += s * np.asarray(deltas, float)
        varied = np.floor(np.asarray(pts) + total).astype(int)
        # the same floor in float32 arithmetic: no point may sit on a boundary
        f32 = np.floor(np.asarray(pts, np.float32) + total.astype(np.float32)).astype(int)
        if not (varied == f32).all():
            raise SystemExit(f"{d!r} at wght {weight}: a varied point rounds on a boundary")
        on = [bool(f & 1) for f in g.flags]
        verts = stb_vertices([tuple(map(int, p)) for p in varied], on, ends)
        out[d] = ((g.xMin, g.yMin, g.xMax, g.yMax), verts)
        mp = hvar.AdvWidthMap.mapping[name]
        store = hvar.VarStore
        data = store.VarData[mp >> 16]
        delta = 0.0
        for ri, dv in zip(data.VarRegionIndex, data.Item[mp & 0xFFFF]):
            (axis,) = store.VarRegionList.Region[ri].VarRegionAxis
            delta += dv * scalar(n, axis.StartCoord, axis.PeakCoord, axis.EndCoord)
        advances.add(int(np.floor(font["hmtx"][name][0] + delta)))
    if len(advances) != 1:
        raise SystemExit(f"digits of unequal advance at wght {weight}: {advances}")
    return advances.pop(), out


def check_weight_rule() -> None:
    """Hershey putText at thickness t equals FontFace putText at weight
    400 (t = 1) or 600."""
    face = cv2.FontFace("sans")
    for t in range(1, 121):
        want = 400 if t == 1 else 600
        for scale in (0.5, 2.0):
            size = int(np.floor(scale / STEP + 0.5))
            a = np.zeros((120, 500), np.uint8)
            b = a.copy()
            cv2.putText(a, DIGITS, (10, 90), FONT, scale, 255, t)
            cv2.putText(b, DIGITS, (10, 90), 255, face, size, want)
            if not (a == b).all():
                raise SystemExit(f"thickness {t} at scale {scale} is not weight {want}")
    print("  thickness 1 draws weight 400, thicknesses 2-120 weight 600")


def write(advances: dict, glyphs: dict, ascent: int) -> str:
    lines = []
    for w in WEIGHTS:
        lines.append(f"    {w}: {{")
        for d in DIGITS:
            box, verts = glyphs[w][d]
            flat = ", ".join(str(v) for vert in verts for v in vert)
            body = _wrap(f"({flat})", 8)
            lines.append(f'        "{d}": ({box},\n{body}),')
        lines.append("    },")
    return TEMPLATE.format(ascent=ascent, advances=advances, glyphs="\n".join(lines))


def _wrap(text: str, indent: int, width: int = 92) -> str:
    out, line = [], " " * indent
    for tok in text.split(" "):
        if len(line) + len(tok) + 1 > width and line.strip():
            out.append(line.rstrip())
            line = " " * indent
        line += tok + " "
    out.append(line.rstrip())
    return "\n".join(out)


TEMPLATE = '''"""The digits "0"-"9" of Rubik, the font cv2 5.0.0 draws
FONT_HERSHEY_SIMPLEX with, as outlines at the two weights it draws them in.

Written by scripts/make_digit_outlines.py from the Rubik.ttf that the cv2
library carries; do not edit. cv2.putText draws a (font scale, thickness)
as Rubik at a pixel size of round(scale / STEP) and at weight 400 for
thickness 1, 600 from 2 up; core/draw.py rasterises these outlines at
size / ASCENT pixels per font unit (core/cpp/draw.cpp) and moves the pen
by ADVANCE[weight] of those, rounded to 1/64 pixel and floored, a digit. `GLYPHS[weight][digit]` is
(the glyph header's (xMin, yMin, xMax, yMax), the stb_truetype vertices as
flat (type, x, y, cx, cy) runs: type 1 moves, 2 draws a line, 3 a
quadratic with control point (cx, cy)), in font units, y up. The weights
are resolved from the font's variation tables, each point floored to an
integer as cv2 does; the script checked the port's drawing against cv2's
at every enumeration size before writing.

Rubik: Copyright 2015 The Rubik Project Authors
(https://github.com/googlefonts/rubik). This Font Software is licensed
under the SIL Open Font License, Version 1.1 (https://openfontlicense.org).
"""
from __future__ import annotations

DIGITS = "0123456789"
#: the tallest image whose enumeration sizes were checked against cv2:
#: every class up to 16384 rows, one digit at 32768 and 65500 (the
#: tallest JPEG)
MAX_ROWS = 65500
#: font scale per pixel of font size
STEP = 0.037
#: font units to the pixel size
ASCENT = {ascent}
#: weight of a thickness: 400 at 1, 600 from 2 up
WEIGHTS = {{False: 400, True: 600}}
#: the digits' advance in font units, a weight
ADVANCE = {advances}
GLYPHS = {{
{glyphs}
}}


def render_class(scale: float, thickness: int) -> tuple[int, bool]:
    """(pixel size, bold) that cv2 draws a font scale and thickness at."""
    size = int(scale / STEP + 0.5) if scale > 0 else 0
    if size < 1:
        raise ValueError(f"font scale {{scale}} draws no digit")
    return size, thickness >= 2
'''


# --------------------------------------------------------------- the check
def enumeration_sizes(rows: int) -> tuple[float, int]:
    """(font scale, thickness) of the enumeration's digits on an image
    `rows` high (JAX topology/enumerate_components.py:129-130)."""
    return max(0.4, rows / 900.0), int(max(1, rows / 600.0))


def check_heights(max_rows: int) -> list[int]:
    """Every class's first height and the two heights on each side of
    every class boundary, for images 1 to max_rows rows high."""
    def key(r):
        scale, t = enumeration_sizes(r)
        return int(scale / STEP + 0.5), t >= 2

    rows, prev = set(), None
    for r in range(1, max_rows + 1):
        k = key(r)
        if k != prev:
            rows.update(x for x in range(r - 2, r + 2) if 1 <= x <= max_rows)
        prev = k
    return sorted(rows)


def drawn_pair(draw, rows: int, text: str = DIGITS):
    """cv2's and the port's enumeration drawing of `text` at an image
    height's sizes: white halo, then blue digits, on a white canvas just
    large enough."""
    scale, t = enumeration_sizes(rows)
    (tw, th), base = cv2.getTextSize(text, FONT, scale, t + 2)
    pad = 4 + th // 4
    shape = (th + base + 2 * pad, tw + 2 * pad, 3)
    org = (pad, pad + th)
    want = np.full(shape, 255, np.uint8)
    cv2.putText(want, text, org, FONT, scale, (255, 255, 255), t + 2, cv2.LINE_AA)
    cv2.putText(want, text, org, FONT, scale, (0, 0, 255), t, cv2.LINE_AA)
    # halo in white on white shows nothing: draw it dark on both sides
    want2 = np.full(shape, 255, np.uint8)
    cv2.putText(want2, text, org, FONT, scale, (40, 90, 10), t + 2, cv2.LINE_AA)
    cv2.putText(want2, text, org, FONT, scale, (0, 0, 255), t, cv2.LINE_AA)
    got = np.full(shape, 255, np.uint8)
    draw.put_text(got, text, org, scale, (255, 255, 255), t + 2)
    draw.put_text(got, text, org, scale, (0, 0, 255), t)
    got2 = np.full(shape, 255, np.uint8)
    draw.put_text(got2, text, org, scale, (40, 90, 10), t + 2)
    draw.put_text(got2, text, org, scale, (0, 0, 255), t)
    sizes = [(cv2.getTextSize(text, FONT, scale, tt), draw.get_text_size(text, scale, tt))
             for tt in (t, t + 2)]
    return (want, want2), (got, got2), sizes


def check(module_text: str, max_rows: int) -> None:
    sys.path.insert(0, str(REPO))
    name = "circuitvision_tpu_torch.core.rubik_digits"
    mod = importlib.util.module_from_spec(importlib.util.spec_from_loader(name, loader=None))
    exec(module_text, mod.__dict__)
    sys.modules[name] = mod  # the table about to be written, in place of the committed one
    from circuitvision_tpu_torch.core import draw
    heights = check_heights(max_rows)
    for rows in heights:
        want, got, sizes = drawn_pair(draw, rows)
        for w, g in zip(want, got):
            if not (w == g).all():
                raise SystemExit(f"the drawing at {rows} rows differs from cv2's "
                                 f"({int((w != g).sum())} bytes)")
        for (cv, port) in sizes:
            if tuple(cv) != tuple(port):
                raise SystemExit(f"getTextSize at {rows} rows: cv2 {cv}, port {port}")
    for rows in (32768, 65500):
        for d in "08":
            want, got, sizes = drawn_pair(draw, rows, d)
            if any(not (w == g).all() for w, g in zip(want, got)) or any(
                    tuple(c) != tuple(p) for c, p in sizes):
                raise SystemExit(f"digit {d} at {rows} rows differs from cv2's")
    print(f"  the port's drawing equals cv2's at {len(heights)} heights from 1 to {max_rows} "
          "rows (every class and both sides of each boundary) and at 32768 and 65500")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check-only", action="store_true",
                    help="check the committed file against cv2 and write nothing")
    ap.add_argument("--max-rows", type=int, default=16384)
    args = ap.parse_args()
    if args.check_only:
        check(OUT.read_text(), args.max_rows)
        return
    font = TTFont(io.BytesIO(rubik_bytes()))
    check_weight_rule()
    advances, glyphs = {}, {}
    for w in WEIGHTS:
        advances[w], glyphs[w] = instance(font, w)
    text = write(advances, glyphs, font["hhea"].ascent)
    check(text, args.max_rows)
    OUT.write_text(text)
    print(f"wrote {OUT.relative_to(REPO)} ({len(text)} bytes)")


if __name__ == "__main__":
    main()
