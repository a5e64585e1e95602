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

It also writes circuitvision_tpu_torch/core/hershey_digits.py, the digits
"0"-"9" at every size the enumeration image draws
(topology/enumerate_components.py: font scale max(0.4, h / 900) and
thickness int(max(1, h / 600)) for an image h rows high, a halo at
thickness + 2 under the digits) for h from 1 to MAX_ROWS. Those sizes
render as few classes, and the rule that names a size's class is found
here from the renders, not assumed: at each thickness the class changes
where the text height that getTextSize gives steps by one pixel, and
bisecting cv2's renders between two heights' scales puts every such step
at (k + 0.5) · STEP of the scale, STEP the mean spacing of the steps; a
thickness of 1 draws one weight and every thickness from 2 up another.
So a size's class is (round(scale / STEP), thickness ≥ 2). Before it
writes anything the script checks that rule on the renders at every
height — two sizes render alike exactly when their classes agree — and
that the port's drawing (core/draw.put_text with the new table) of
"0123456789" at both passes, white halo then blue digits on white,
equals cv2's at every height, as does its getTextSize; and within each
class that every pair of digits is two glyphs at integer advances.
"""
from __future__ import annotations

import base64
import importlib.util
import lzma
import sys
import tempfile
import zlib
from pathlib import Path

import cv2
import numpy as np

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "circuitvision_tpu_torch" / "core" / "hershey.py"
DIGITS_OUT = OUT.with_name("hershey_digits.py")
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


DIGITS = "0123456789"
#: the tallest image the enumeration's digit table covers
MAX_ROWS = 4096


def enumeration_sizes(rows: int) -> tuple[float, int]:
    """(font scale, thickness) of the enumeration's digits on an image
    `rows` high (JAX topology/enumerate_components.py:129-130)."""
    return max(0.4, rows / 900.0), int(max(1, rows / 600.0))


def digits_render(scale, thickness):
    """cv2's "0123456789" alone on a black canvas — its inked box's offset
    from the origin, shape and pixels — and its getTextSize."""
    (tw, th), base = cv2.getTextSize(DIGITS, FONT, scale, thickness)
    pad = int(20 * scale) + 8
    img = np.zeros((th + base + 2 * pad, tw + 2 * pad), np.uint8)
    cv2.putText(img, DIGITS, (pad, pad + th), FONT, scale, 255, thickness)
    ys, xs = np.nonzero(img)
    ink = img[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
    return (int(xs.min()) - pad, int(ys.min()) - pad - th, ink.shape, ink.tobytes()), (tw, th, base)


def find_step(pairs, renders) -> float:
    """The scale step between render classes, from cv2's renders: at each
    thickness, bisect the scale between neighbouring sizes that render
    differently, and check every step lies at (k + 0.5) · STEP, k the
    text height below it."""
    steps = []  # (boundary scale, text height below it)
    for thickness in sorted({t for _s, t in pairs}):
        scales = sorted(s for s, t in pairs if t == thickness)
        for lo, hi in zip(scales, scales[1:]):
            if renders[(lo, thickness)] == renders[(hi, thickness)]:
                continue
            want = renders[(lo, thickness)]
            for _ in range(40):
                mid = (lo + hi) / 2
                lo, hi = (mid, hi) if digits_render(mid, thickness) == want else (lo, mid)
            steps.append((hi, want[1][1]))
    step = sum(b for b, _k in steps) / sum(k + 0.5 for _b, k in steps)
    step = round(step, 9)
    bad = [(b, k) for b, k in steps if abs(b - (k + 0.5) * step) > 1e-9]
    if bad:
        raise SystemExit(f"class steps off (k + 0.5) x {step}: {bad[:5]}")
    print(f"  {len(steps)} class steps, each at (k + 0.5) x {step} of the font scale")
    return step


def digit_class(scale, thickness, step) -> tuple[int, bool]:
    return int(np.floor(scale / step + 0.5)), thickness >= 2


def digit_glyph(c, scale, thickness):
    """(advance, dx, dy, coverage) of one digit, from its render alone;
    the advance is getTextSize's width less one (checked on the pairs)."""
    pad = int(60 * scale) + 20
    img = np.zeros((4 * pad, 3 * pad), np.uint8)
    cv2.putText(img, c, (pad, 2 * pad), FONT, scale, 255, thickness)
    ys, xs = np.nonzero(img)
    cov = img[ys.min():ys.max() + 1, xs.min():xs.max() + 1].copy()
    adv = cv2.getTextSize(c, FONT, scale, thickness)[0][0] - 1
    return adv, int(xs.min()) - pad, int(ys.min()) - 2 * pad, cov


def digit_tables():
    """{(height, bold): (sizes seen, blob)} for every class the
    enumeration draws at heights 1..MAX_ROWS, and the step."""
    pairs = sorted({(s, tt) for rows in range(1, MAX_ROWS + 1)
                    for s, t in [enumeration_sizes(rows)] for tt in (t, t + 2)})
    renders = {p: digits_render(*p) for p in pairs}
    print(f"  {len(pairs)} (scale, thickness) pairs at heights 1..{MAX_ROWS}, "
          f"{len(set(renders.values()))} distinct renders")
    step = find_step(pairs, renders)
    classes: dict = {}
    for p in pairs:
        classes.setdefault(digit_class(*p, step), []).append(p)
    for key, members in classes.items():
        seen = {renders[p] for p in members}
        if len(seen) != 1 or seen.pop()[1][1] != key[0]:
            raise SystemExit(f"class {key} holds sizes that render differently: {members[:4]}")
    if len(classes) != len(set(renders.values())):
        raise SystemExit("two classes render alike: the rule splits one render")
    tables = {}
    for key, members in sorted(classes.items()):
        scale, thickness = members[0]
        glyphs = {c: digit_glyph(c, scale, thickness) for c in DIGITS}
        for a in DIGITS:  # every pair: two glyphs at an integer advance
            for b in DIGITS:
                img = np.zeros((glyphs[a][3].shape[0] * 3 + 40, 400 + 4 * glyphs[a][0]),
                               np.uint8)
                want = img.copy()
                cv2.putText(want, a + b, (20, img.shape[0] // 2), FONT, scale, 255, thickness)
                for c, x in ((a, 20), (b, 20 + glyphs[a][0])):
                    blend(img, glyphs[c][1:], x, img.shape[0] // 2)
                if not (img == want).all():
                    raise SystemExit(f"pair {a + b!r} in class {key} is not two glyphs")
        height = cv2.getTextSize(DIGITS, FONT, scale, thickness)[0][1]
        blob = bytearray(np.array([height], np.int16).tobytes())
        for c in DIGITS:
            adv, dx, dy, cov = glyphs[c]
            blob += np.array([adv, dx, dy, cov.shape[0], cov.shape[1]], np.int16).tobytes()
            blob += cov.tobytes()
        tables[key] = base64.b85encode(lzma.compress(bytes(blob), preset=9)).decode()
    return step, tables, pairs


def check_digits(draw, pairs) -> None:
    """The port's enumeration drawing against cv2's at every height:
    "0123456789" as a white halo at thickness + 2, then blue (0, 0, 255)
    digits at the thickness, on a white RGB page; and getTextSize."""
    done = set()
    for rows in range(1, MAX_ROWS + 1):
        scale, thickness = enumeration_sizes(rows)
        if (scale, thickness) in done:
            continue
        done.add((scale, thickness))
        for t in (thickness, thickness + 2):
            got = draw.get_text_size(DIGITS, scale, t)
            if got != cv2.getTextSize(DIGITS, FONT, scale, t):
                raise SystemExit(f"getTextSize at height {rows}, thickness {t}: {got}")
        (tw, th), base = cv2.getTextSize(DIGITS, FONT, scale, thickness + 2)
        page = np.full((th + base + 30, tw + 30, 3), 255, np.uint8)
        want, got, org = page.copy(), page.copy(), (12, th + 12)
        cv2.putText(want, DIGITS, org, FONT, scale, (255, 255, 255), thickness + 2, cv2.LINE_AA)
        cv2.putText(want, DIGITS, org, FONT, scale, (0, 0, 255), thickness, cv2.LINE_AA)
        draw.put_text(got, DIGITS, org, scale, (255, 255, 255), thickness + 2)
        draw.put_text(got, DIGITS, org, scale, (0, 0, 255), thickness)
        if not (got == want).all():
            raise SystemExit(f"the port's digits differ from cv2's at height {rows}")
    print(f"  the port's digits equal cv2's at every height 1..{MAX_ROWS} "
          f"({len(done)} sizes, {len(pairs)} with the halo's)")


DIGITS_TEMPLATE = '''"""cv2's FONT_HERSHEY_SIMPLEX digits at every size the enumeration image
draws, as OpenCV 5.0.0 draws them.

Written by scripts/make_glyph_table.py, which renders the digits with
cv2.putText; do not edit. The enumeration
(topology/enumerate_components.py) draws its ids at font scale
max(0.4, h / 900) and thickness int(max(1, h / 600)), a white halo at
thickness + 2 under them, on an image h rows high. For h from 1 to
MAX_ROWS those sizes render as {n_classes} classes: cv2's text height
steps by one pixel at every (k + 0.5) · STEP of the scale, and a
thickness of 1 draws one weight, every thickness from 2 up another. So
`render_class(scale, thickness)` is (round(scale / STEP), thickness ≥ 2),
the rule the script found from the renders and checked at every such
height; off those heights' scales it is untested. `glyphs` gives a
class's digits as core/hershey.py gives its glyphs, (advance, dx, dy,
coverage), and `text_height` getTextSize's height.
"""
from __future__ import annotations

import base64
import functools
import lzma
import math

import numpy as np

DIGITS = "0123456789"
#: the tallest image whose enumeration sizes the table was checked at
MAX_ROWS = {max_rows}
#: font scale per pixel of text height (a class boundary every STEP)
STEP = {step!r}
_DATA = {{
{data}}}


def render_class(scale: float, thickness: int) -> tuple[int, bool]:
    """(text height, bold) of a size; KeyError for a class the table does
    not hold."""
    key = (math.floor(scale / STEP + 0.5), thickness >= 2)
    if key not in _DATA:
        raise KeyError(f"no digit glyphs at font scale {{scale}}, thickness {{thickness}}")
    return key


@functools.lru_cache(maxsize=None)
def _decode(key: tuple[int, bool]) -> tuple[int, dict]:
    blob = lzma.decompress(base64.b85decode(_DATA[key]))
    height, at, out = int(np.frombuffer(blob[:2], np.int16)[0]), 2, {{}}
    for c in DIGITS:
        adv, dx, dy, h, w = np.frombuffer(blob[at:at + 10], np.int16).astype(int)
        at += 10
        out[c] = (int(adv), int(dx), int(dy),
                  np.frombuffer(blob[at:at + h * w], np.uint8).reshape(h, w))
        at += h * w
    return height, out


def glyphs(scale: float, thickness: int) -> dict:
    """{{digit: (advance, dx, dy, coverage uint8 (h, w))}} at a size."""
    return _decode(render_class(scale, thickness))[1]


def text_height(scale: float, thickness: int) -> int:
    """getTextSize's height at a size."""
    return _decode(render_class(scale, thickness))[0]
'''


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(f"circuitvision_tpu_torch.core.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _entries(items) -> str:
    out = []
    for key, blob in items:
        lines = "\n".join(f'        "{blob[i:i + 76]}"' for i in range(0, len(blob), 76))
        out.append(f"    {key}: (\n{lines}\n    ),\n")
    return "".join(out)


def main() -> int:
    heights, data = {}, []
    for scale, thickness in SIZES:
        h, blob = table(scale, thickness)
        heights[(scale, thickness)] = h
        data.append(((scale, thickness), blob))
    glyph_text = TEMPLATE.format(height=heights, data=_entries(data))
    print("digits of the enumeration image:")
    step, tables, pairs = digit_tables()
    digits_text = DIGITS_TEMPLATE.format(n_classes=len(tables), max_rows=MAX_ROWS, step=step,
                                         data=_entries(sorted(tables.items())))
    with tempfile.TemporaryDirectory() as tmp:  # check the port's drawing on the new tables
        for name, text in (("hershey", glyph_text), ("hershey_digits", digits_text)):
            (Path(tmp) / f"{name}.py").write_text(text)
            _load(name, Path(tmp) / f"{name}.py")
        sys.path.insert(0, str(REPO))
        from circuitvision_tpu_torch.core import draw

        check_digits(draw, pairs)
    for path, text in ((OUT, glyph_text), (DIGITS_OUT, digits_text)):
        path.write_text(text)
        print(f"wrote {path} ({path.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
