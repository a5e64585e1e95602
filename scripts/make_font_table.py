"""Write circuitvision_tpu_torch/eval/aileron.py: the coverage maps PIL
draws for `ImageFont.load_default(size)` at sizes 8 to 16, the font the
synthetic-data harness prints its values and annotations in.

Each printable ASCII character is drawn alone, with
`ImageDraw.text((X, Y), c, fill=255)` on a black "L" canvas; the table
keeps its coverage map cropped to the ink, the crop's offset from
(X, Y), the advance (`getlength`, an integer: the font is hinted) and
`getbbox(c)`. `eval/glyphs.BitmapFont` composes strings from it.

Before it writes, the script checks the composition byte for byte
against PIL: every printable pair at every size, random strings on
random backgrounds at positions that clip at the image's edges, and
every string the harness can print (the value grammar at size 14, the
annotation words at sizes 8 to 16, the eval set's printed labels and
the pinned netlists' values). It refuses to write if one differs.

Needs PIL (and, for the eval set's strings, the JAX package):
    python scripts/make_font_table.py [--check-only]
"""
from __future__ import annotations

import argparse
import base64
import os
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIZES = tuple(range(8, 17))
CHARS = [chr(c) for c in range(32, 127)]
OUT = os.path.join(ROOT, "circuitvision_tpu_torch", "eval", "aileron.py")
X0, Y0, W, H = 30, 12, 120, 48


def glyph_rows(size: int) -> tuple[str, list[tuple]]:
    """(base64 of the zlib'd coverage bytes, metrics rows) at `size`."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.load_default(size=size)
    raw, rows = bytearray(), []
    for c in CHARS:
        im = Image.new("L", (W, H), 0)
        ImageDraw.Draw(im).text((X0, Y0), c, fill=255, font=font)
        a = np.asarray(im)
        adv = font.getlength(c)
        if adv != int(adv):
            raise ValueError(f"size {size} {c!r}: advance {adv} is not an integer")
        ys, xs = np.nonzero(a)
        if len(ys):
            crop = a[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
            dx, dy = int(xs.min()) - X0, int(ys.min()) - Y0
        else:
            crop, dx, dy = np.zeros((0, 0), np.uint8), 0, 0
        raw += crop.tobytes()
        rows.append((ord(c), dx, dy, crop.shape[1], crop.shape[0], int(adv),
                     *map(int, font.getbbox(c))))
    return base64.b64encode(zlib.compress(bytes(raw), 9)).decode(), rows


def harness_strings() -> dict[int, set[str]]:
    """{size: strings} the harness prints: the value grammar and AC values
    at 14, the annotation words at 8–16, whatever the eval set draws, and
    the pinned netlists' values."""
    import json

    from circuitvision_tpu_torch.eval import glyphs

    out: dict[int, set[str]] = {s: set() for s in SIZES}
    mags = (1, 2, 4, 5, 10, 22, 47, 100, 220, 470)
    for _sym, prefixes, _ in glyphs.VALUE_GRAMMAR.values():
        out[14] |= {f"{n}{p}" for n in mags for p in prefixes}
    out[14] |= {f"{m}:{ph}" for m in range(1, 12) for ph in (-90, -45, 0, 45, 90)}
    for s in SIZES:
        out[s] |= set(glyphs._ANNOTATION_WORDS)
    with open(os.path.join(ROOT, "circuitvision_tpu_torch", "eval", "pinned_netlists.json")) as f:
        pinned = json.load(f)
    for entry in pinned.values():
        for line in entry["final"].splitlines():
            parts = line.split()
            if len(parts) >= 4 and parts[3] != "None":
                out[14].add(" ".join(parts[3:]))
    try:
        from PIL import ImageDraw

        from circuitvision_tpu.eval import synth
    except ImportError:
        return out
    real = ImageDraw.ImageDraw.text

    def spy(self, xy, text, *a, font=None, **k):
        out.setdefault(font.size, set()).add(text)
        return real(self, xy, text, *a, font=font, **k)

    ImageDraw.ImageDraw.text = spy
    try:
        synth.make_all_circuits()
    finally:
        ImageDraw.ImageDraw.text = real
    return out


def check(tables: dict[int, tuple[str, list]], n_random: int = 400, sizes=SIZES) -> list:
    """Mismatches of the composed renders against PIL at `sizes` (empty
    when the table is exact)."""
    from PIL import Image, ImageDraw, ImageFont

    from circuitvision_tpu_torch.eval.glyphs import BitmapFont

    bad = []
    rng = np.random.default_rng(0)
    strings = harness_strings()
    for size in sizes:
        font = ImageFont.load_default(size=size)
        table = BitmapFont(size, *tables[size])
        cases = [(s, "white") for s in sorted(strings.get(size, ()))]
        cases += [(a + b, "white") for a in CHARS for b in CHARS]
        cases += ["".join(rng.choice(CHARS, rng.integers(1, 12))) for _ in range(n_random)]
        for k, case in enumerate(cases):
            text, bg = case if isinstance(case, tuple) else (case, "random")
            if font.getbbox(text) != table.getbbox(text):
                bad.append((size, text, "getbbox", font.getbbox(text), table.getbbox(text)))
                continue
            l, t, r, b = font.getbbox(text)
            if bg == "white":
                h, w = b - t + 8, r - l + 8
                img = np.full((h, w, 3), 255, np.uint8)
                x, y = 4 - l, 4 - t
            else:
                h, w = int(rng.integers(4, 50)), int(rng.integers(4, 100))
                img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
                x, y = int(rng.integers(-20, w)), int(rng.integers(-20, h))
            pil = Image.fromarray(img.copy())
            ImageDraw.Draw(pil).text((x, y), text, fill=(0, 0, 0), font=font)
            mine = img.copy()
            table.draw(mine, x, y, text)
            if not np.array_equal(np.asarray(pil), mine):
                bad.append((size, text, "pixels", x, y))
    return bad


def render_module(tables: dict[int, tuple[str, list]]) -> str:
    import PIL
    from PIL import features

    lines = [
        '"""Aileron Regular as PIL draws it for `ImageFont.load_default(size)`',
        f"(Pillow {PIL.__version__}, FreeType {features.version('freetype2')}), sizes "
        f"{SIZES[0]} to {SIZES[-1]}.",
        "",
        "Written by scripts/make_font_table.py, which checks it against PIL",
        "before writing; do not edit. GLYPHS[size] = (base64 of the zlib'd",
        "coverage maps, one row per printable ASCII character: (code, dx, dy,",
        "width, height, advance, *getbbox)). `eval/glyphs.BitmapFont` reads it.",
        '"""',
        "",
        "GLYPHS = {",
    ]
    for size in SIZES:
        data, rows = tables[size]
        lines.append(f"    {size}: (")
        for i in range(0, len(data), 88):
            lines.append(f'        "{data[i:i + 88]}"')
        lines.append("        ,")
        lines.append("        [")
        for i in range(0, len(rows), 4):
            lines.append("            " + " ".join(f"{tuple(r)}," for r in rows[i:i + 4]))
        lines.append("        ],")
        lines.append("    ),")
    lines.append("}")
    return "\n".join(lines) + "\n"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check-only", action="store_true",
                    help="check the committed table against PIL, write nothing")
    args = ap.parse_args()
    if args.check_only:
        from circuitvision_tpu_torch.eval import aileron

        tables = aileron.GLYPHS
    else:
        tables = {s: glyph_rows(s) for s in SIZES}
    bad = check(tables)
    if bad:
        print(f"{len(bad)} mismatches against PIL, first: {bad[:5]}")
        return 1
    print("table matches PIL on every checked string")
    if not args.check_only:
        with open(OUT, "w") as f:
            f.write(render_module(tables))
        print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
