"""Class-distinct schematic glyphs and printed value labels for the
synthetic renders.

Counterpart of the JAX package's `eval/glyphs.py`, byte for byte: a
distinct glyph per class family inside each component box, oriented to
its lead axis, and the component's value printed beside the box as a
`text`-class BBox. The text is drawn from `eval/aileron.py`, a table of
the coverage maps PIL draws for `ImageFont.load_default(size)` (the
FreeType font Aileron Regular), composed as PIL composes them: integer
advances, overlapping coverage joined as a + b − a·b/255, and the ink
blended into the image as PIL's `ImageDraw.text` blends black
(`scripts/make_font_table.py` writes the table and checks it against
PIL). No PIL is needed here.
"""
from __future__ import annotations

from typing import Optional, Sequence

import base64
import functools
import zlib

import numpy as np

from ..core.types import BBox

_BLACK = 0


def _clip(v, lo, hi):
    return max(lo, min(hi, int(v)))


def _hline(img, y, x0, x1, t=2):
    h, w = img.shape[:2]
    y = _clip(y, 0, h - 1)
    img[y : min(y + t, h), _clip(min(x0, x1), 0, w) : _clip(max(x0, x1), 0, w)] = _BLACK


def _vline(img, x, y0, y1, t=2):
    h, w = img.shape[:2]
    x = _clip(x, 0, w - 1)
    img[_clip(min(y0, y1), 0, h) : _clip(max(y0, y1), 0, h), x : min(x + t, w)] = _BLACK


def _line(img, p0, p1, t=2):
    """Thick line segment via dense sampling (host-side, tiny images)."""
    x0, y0 = p0
    x1, y1 = p1
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    xs = np.linspace(x0, x1, n)
    ys = np.linspace(y0, y1, n)
    h, w = img.shape[:2]
    r = t // 2
    for x, y in zip(xs, ys):
        yy0, yy1 = _clip(y - r, 0, h), _clip(y + r + 1, 0, h)
        xx0, xx1 = _clip(x - r, 0, w), _clip(x + r + 1, 0, w)
        img[yy0:yy1, xx0:xx1] = _BLACK


def _circle(img, cx, cy, rad, t=2):
    h, w = img.shape[:2]
    y0, y1 = _clip(cy - rad - t, 0, h), _clip(cy + rad + t + 1, 0, h)
    x0, x1 = _clip(cx - rad - t, 0, w), _clip(cx + rad + t + 1, 0, w)
    if y1 <= y0 or x1 <= x0:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    ring = np.abs(d - rad) <= t / 2 + 0.3
    img[y0:y1, x0:x1][ring] = _BLACK


def _arc_top(img, cx, cy, rad, t=2):
    h, w = img.shape[:2]
    y0, y1 = _clip(cy - rad - t, 0, h), _clip(cy + 1, 0, h)
    x0, x1 = _clip(cx - rad - t, 0, w), _clip(cx + rad + t + 1, 0, w)
    if y1 <= y0 or x1 <= x0:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    ring = (np.abs(d - rad) <= t / 2 + 0.3) & (yy <= cy)
    img[y0:y1, x0:x1][ring] = _BLACK


def _triangle(img, p0, p1, p2):
    """Filled triangle (barycentric test over the AABB)."""
    h, w = img.shape[:2]
    xs = [p0[0], p1[0], p2[0]]
    ys = [p0[1], p1[1], p2[1]]
    x0, x1 = _clip(min(xs), 0, w), _clip(max(xs) + 1, 0, w)
    y0, y1 = _clip(min(ys), 0, h), _clip(max(ys) + 1, 0, h)
    if y1 <= y0 or x1 <= x0:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]

    def edge(a, b):
        return (xx - a[0]) * (b[1] - a[1]) - (yy - a[1]) * (b[0] - a[0])

    e0, e1, e2 = edge(p0, p1), edge(p1, p2), edge(p2, p0)
    inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | (
        (e0 <= 0) & (e1 <= 0) & (e2 <= 0)
    )
    img[y0:y1, x0:x1][inside] = _BLACK


def _lead_axis(box: BBox) -> str:
    """'h' when the component sits on a horizontal wire run (wide box)."""
    return "h" if box.width >= box.height else "v"


def draw_glyph(img: np.ndarray, box: BBox, direction: Optional[str] = None,
               rng: Optional[np.random.Generator] = None) -> None:
    """Draw the class-distinct symbol for `box` inside its bounds.

    direction: for polarized classes (sources, diodes), which way the
    positive terminal / anode points ('UP','DOWN','LEFT','RIGHT'); the
    glyph encodes it (source + mark position, diode triangle direction)
    so a trained reader can recover semantic direction from pixels —
    the capability behind _get_semantic_direction_from_vlm
    (src/circuit_analyzer.py:2036-2143)."""
    cls = box.class_name
    m = 6  # inner margin
    x0, y0 = box.xmin + m, box.ymin + m
    x1, y1 = box.xmax - m, box.ymax - m
    if x1 - x0 < 8 or y1 - y0 < 8:
        return
    cx, cy = (x0 + x1) // 2, (y0 + y1) // 2
    ax = _lead_axis(box)
    span = (x1 - x0) if ax == "h" else (y1 - y0)
    half = min(x1 - x0, y1 - y0) // 2

    if cls.startswith("resistor"):
        n_zig = 5
        amp = max(4, half - 3)
        pts = []
        for i in range(n_zig + 1):
            frac = i / n_zig
            off = amp if i % 2 == 1 else -amp
            if i in (0, n_zig):
                off = 0
            if ax == "h":
                pts.append((x0 + frac * (x1 - x0), cy + off))
            else:
                pts.append((cx + off, y0 + frac * (y1 - y0)))
        for a, b in zip(pts[:-1], pts[1:]):
            _line(img, a, b)
        if cls == "resistor.adjustable":
            _line(img, (x0, y1), (x1, y0), t=2)
    elif cls.startswith("capacitor"):
        gap = max(3, span // 8)
        plate = max(6, half - 2)
        if ax == "h":
            _vline(img, cx - gap, cy - plate, cy + plate, t=3)
            _vline(img, cx + gap, cy - plate, cy + plate, t=3)
            _hline(img, cy, x0, cx - gap)
            _hline(img, cy, cx + gap, x1)
        else:
            _hline(img, cy - gap, cx - plate, cx + plate, t=3)
            _hline(img, cy + gap, cx - plate, cx + plate, t=3)
            _vline(img, cx, y0, cy - gap)
            _vline(img, cx, cy + gap, y1)
        if cls == "capacitor.polarized":
            _hline(img, y0 + 2, x0 + 2, x0 + 8, t=2)
            _vline(img, x0 + 5, y0 - 1, y0 + 5, t=2)
    elif cls == "inductor":
        n_arc = 3
        rad = max(3, span // (2 * n_arc))
        if ax == "h":
            for i in range(n_arc):
                _arc_top(img, x0 + rad + i * 2 * rad, cy, rad)
            _hline(img, cy, x0 + n_arc * 2 * rad, x1)
        else:
            for i in range(n_arc):
                _circle(img, cx, y0 + rad + i * 2 * rad, rad)
    elif cls == "voltage.battery":
        # standard battery symbol: long thin plate (+) and short thick
        # plate (−) across the lead axis — previously drawn with the SAME
        # circled-± glyph as voltage.dc, which made the two classes
        # pixel-indistinguishable and pinned the rarer one's AP@50 at
        # 0.08 (detector cannot learn a distinction that isn't drawn)
        d = direction or "UP"
        long_p = max(7, half - 1)
        short_p = max(3, long_p // 2)
        gap = max(3, span // 8)
        if ax == "h":
            # positive (long) plate toward `d`==RIGHT side, else left
            px_, nx_ = (cx + gap, cx - gap) if d == "RIGHT" else \
                (cx - gap, cx + gap)
            _vline(img, px_, cy - long_p, cy + long_p, t=2)
            _vline(img, nx_, cy - short_p, cy + short_p, t=4)
            _hline(img, cy, x0, min(px_, nx_))
            _hline(img, cy, max(px_, nx_), x1)
            pos = (px_ + (6 if d == "RIGHT" else -6), cy - long_p - 4)
        else:
            py_, ny_ = (cy - gap, cy + gap) if d != "DOWN" else \
                (cy + gap, cy - gap)
            _hline(img, py_, cx - long_p, cx + long_p, t=2)
            _hline(img, ny_, cx - short_p, cx + short_p, t=4)
            _vline(img, cx, y0, min(py_, ny_))
            _vline(img, cx, max(py_, ny_), y1)
            pos = (cx + long_p + 4, py_ + (-4 if d != "DOWN" else 4))
        # small '+' beside the long plate (the SIGN evidence)
        _hline(img, pos[1], pos[0] - 2, pos[0] + 2, t=1)
        _vline(img, pos[0], pos[1] - 2, pos[1] + 2, t=1)
    elif cls in ("voltage.dc", "current.dc",
                 "current.dependent", "voltage.ac", "voltage.dependent"):
        rad = max(6, half - 2)
        _circle(img, cx, cy, rad)
        d = direction or "UP"
        if cls in ("voltage.dc", "voltage.dependent"):
            # '+' on the positive side, '−' opposite
            off = rad // 2 + 1
            pos = {
                "UP": (cx, cy - off), "DOWN": (cx, cy + off),
                "LEFT": (cx - off, cy), "RIGHT": (cx + off, cy),
            }[d]
            neg = {
                "UP": (cx, cy + off), "DOWN": (cx, cy - off),
                "LEFT": (cx + off, cy), "RIGHT": (cx - off, cy),
            }[d]
            _hline(img, pos[1], pos[0] - 3, pos[0] + 3, t=2)
            _vline(img, pos[0], pos[1] - 3, pos[1] + 3, t=2)
            _hline(img, neg[1], neg[0] - 3, neg[0] + 3, t=2)
        elif cls == "voltage.ac":
            # small sine wave inside
            xs = np.linspace(cx - rad + 3, cx + rad - 3, 24)
            ys = cy + np.sin(np.linspace(0, 2 * np.pi, 24)) * max(2, rad // 3)
            for a, b in zip(zip(xs[:-1], ys[:-1]), zip(xs[1:], ys[1:])):
                _line(img, a, b, t=2)
            if direction is not None:
                # explicit polarity: '+' on the positive side (the SIGN
                # evidence the reference's direction VLM reads off AC
                # sources, src/circuit_analyzer.py:2051-2075) — drawn
                # only when a direction is pinned so legacy renders
                # (no ac direction) are unchanged.
                off = rad // 2 + 2
                pos = {
                    "UP": (cx, cy - off), "DOWN": (cx, cy + off),
                    "LEFT": (cx - off, cy), "RIGHT": (cx + off, cy),
                }[d]
                _hline(img, pos[1], pos[0] - 3, pos[0] + 3, t=2)
                _vline(img, pos[0], pos[1] - 3, pos[1] + 3, t=2)
        else:  # current source: arrow toward `direction`
            ln = rad - 3
            tip = {
                "UP": (cx, cy - ln), "DOWN": (cx, cy + ln),
                "LEFT": (cx - ln, cy), "RIGHT": (cx + ln, cy),
            }[d]
            tail = (2 * cx - tip[0], 2 * cy - tip[1])
            _line(img, tail, tip, t=2)
            # arrow head: two short barbs
            bx = (tip[0] - tail[0]) / max(1, abs(tip[0] - tail[0]) + abs(tip[1] - tail[1]))
            by = (tip[1] - tail[1]) / max(1, abs(tip[0] - tail[0]) + abs(tip[1] - tail[1]))
            _line(img, tip, (tip[0] - 4 * bx - 3 * by, tip[1] - 4 * by + 3 * bx), t=2)
            _line(img, tip, (tip[0] - 4 * bx + 3 * by, tip[1] - 4 * by - 3 * bx), t=2)
    elif cls.startswith("diode"):
        d = direction or ("RIGHT" if ax == "h" else "DOWN")
        tri = max(5, half - 3)
        if d == "RIGHT":
            _triangle(img, (cx - tri, cy - tri), (cx - tri, cy + tri), (cx + tri, cy))
            _vline(img, cx + tri, cy - tri, cy + tri, t=3)
        elif d == "LEFT":
            _triangle(img, (cx + tri, cy - tri), (cx + tri, cy + tri), (cx - tri, cy))
            _vline(img, cx - tri, cy - tri, cy + tri, t=3)
        elif d == "DOWN":
            _triangle(img, (cx - tri, cy - tri), (cx + tri, cy - tri), (cx, cy + tri))
            _hline(img, cy + tri, cx - tri, cx + tri, t=3)
        else:  # UP
            _triangle(img, (cx - tri, cy + tri), (cx + tri, cy + tri), (cx, cy - tri))
            _hline(img, cy - tri, cx - tri, cx + tri, t=3)
        if cls == "diode.zener":
            _hline(img, y0, x0, x0 + 6, t=2)
        elif cls == "diode.light_emitting":
            _line(img, (x1 - 6, y0 + 2), (x1 - 1, y0 - 3), t=1)
            _line(img, (x1 - 9, y0 + 5), (x1 - 4, y0), t=1)
    elif cls == "transistor.bjt":
        rad = max(6, half - 2)
        _circle(img, cx, cy, rad)
        _vline(img, cx - rad // 2, cy - rad + 3, cy + rad - 3, t=3)
        _line(img, (cx - rad // 2, cy - 2), (cx + rad - 2, cy - rad + 2), t=2)
        _line(img, (cx - rad // 2, cy + 2), (cx + rad - 2, cy + rad - 2), t=2)
    elif cls in ("gnd", "vss"):
        wdt = x1 - x0
        _vline(img, cx, y0, cy, t=2)
        _hline(img, cy, x0, x1, t=2)
        _hline(img, cy + 4, x0 + wdt // 5, x1 - wdt // 5, t=2)
        _hline(img, cy + 8, x0 + 2 * wdt // 5, x1 - 2 * wdt // 5, t=2)
    elif cls == "terminal":
        _circle(img, cx, cy, max(3, half // 2))
    else:  # unknown / ICs / gates: box with an X
        _hline(img, y0, x0, x1)
        _hline(img, y1, x0, x1)
        _vline(img, x0, y0, y1)
        _vline(img, x1, y0, y1)
        _line(img, (x0, y0), (x1, y1), t=1)


def _div255(v: np.ndarray) -> np.ndarray:
    """PIL's DIV255: v / 255 rounded, for 0 ≤ v ≤ 255²."""
    t = v + 128
    return ((t >> 8) + t) >> 8


class BitmapFont:
    """One size of a table written by scripts/make_font_table.py: per
    printable ASCII character its coverage map, that map's offset from
    the draw position, its advance and its `getbbox`."""

    def __init__(self, size: int, data: str, metrics: Sequence[tuple]):
        raw = zlib.decompress(base64.b64decode(data))
        self.size = size
        self.glyphs = {}
        at = 0
        for code, dx, dy, w, h, adv, l, t, r, b in metrics:
            bitmap = np.frombuffer(raw, np.uint8, w * h, at).reshape(h, w).astype(np.int32)
            at += w * h
            self.glyphs[chr(code)] = (dx, dy, bitmap, adv, (l, t, r, b))

    def getbbox(self, text: str) -> tuple[int, int, int, int]:
        """PIL's `FreeTypeFont.getbbox(text)` (anchor "la")."""
        x, box = 0, None
        for c in text:
            _dx, _dy, _bm, adv, (l, t, r, b) = self.glyphs[c]
            g = (x + l, t, x + r, b)
            box = g if box is None else (min(box[0], g[0]), min(box[1], g[1]),
                                         max(box[2], g[2]), max(box[3], g[3]))
            x += adv
        return box if box is not None else (0, 0, 0, 0)

    def draw(self, img: np.ndarray, x: int, y: int, text: str) -> None:
        """`ImageDraw.Draw(img).text((x, y), text, fill=(0, 0, 0), font=…)`
        on an RGB uint8 array, in place."""
        h, w = img.shape[:2]
        placed, pen = [], 0
        for c in text:
            dx, dy, bm, adv, _ = self.glyphs[c]
            if bm.size:
                placed.append((x + pen + dx, y + dy, bm))
            pen += adv
        if not placed:
            return
        x0 = min(p[0] for p in placed)
        y0 = min(p[1] for p in placed)
        x1 = max(p[0] + p[2].shape[1] for p in placed)
        y1 = max(p[1] + p[2].shape[0] for p in placed)
        cov = np.zeros((y1 - y0, x1 - x0), np.int32)
        for gx, gy, bm in placed:
            sl = cov[gy - y0:gy - y0 + bm.shape[0], gx - x0:gx - x0 + bm.shape[1]]
            sl[...] = sl + bm - _div255(sl * bm)
        cx0, cy0, cx1, cy1 = max(x0, 0), max(y0, 0), min(x1, w), min(y1, h)
        if cx1 <= cx0 or cy1 <= cy0:
            return
        c = cov[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0, None]
        region = img[cy0:cy1, cx0:cx1]
        region[...] = _div255(region.astype(np.int32) * (255 - c))


@functools.lru_cache(maxsize=None)
def load_font(size: int) -> BitmapFont:
    """PIL's `ImageFont.load_default(size=size)`, for the sizes the
    harness draws (8 to 16)."""
    from . import aileron

    if size not in aileron.GLYPHS:
        raise KeyError(f"no font table at size {size}; have {sorted(aileron.GLYPHS)}")
    return BitmapFont(size, *aileron.GLYPHS[size])


def draw_value_text(
    img: np.ndarray, box: BBox, text: str,
    taken: list,
) -> Optional[BBox]:
    """Print `text` adjacent to `box` (black, Aileron at 14 px),
    avoiding rectangles already in `taken`; returns a `text`-class BBox
    covering the printed pixels (appended to `taken`), or None if no
    spot fit inside the image."""
    # 14 px: the size printed value labels actually have relative to
    # ~50 px components on real schematics.
    font = load_font(14)
    l, t, r, b = font.getbbox(text)
    tw, th = r - l, b - t
    h, w = img.shape[:2]
    pad = 4
    candidates = [
        (box.xmax + pad, box.ymin + (box.height - th) // 2),  # right
        (box.xmin - tw - pad, box.ymin + (box.height - th) // 2),  # left
        (box.xmin + (box.width - tw) // 2, box.ymin - th - pad),  # above
        (box.xmin + (box.width - tw) // 2, box.ymax + pad),  # below
    ]
    for x, y in candidates:
        rect = (x - 2, y - 2, x + tw + 2, y + th + 2)
        if rect[0] < 0 or rect[1] < 0 or rect[2] >= w or rect[3] >= h:
            continue
        if any(
            min(rect[2], o[2]) > max(rect[0], o[0])
            and min(rect[3], o[3]) > max(rect[1], o[1])
            for o in taken
        ):
            continue
        region = img[rect[1] : rect[3], rect[0] : rect[2]]
        if (region < 128).any():  # would overprint wires/glyphs
            continue
        # offset by the font bearing (l, t) so the ink lands on
        # [x, x+tw) x [y, y+th), the rect recorded and checked above
        font.draw(img, x - l, y - t, text)
        taken.append(rect)
        return BBox(
            class_name="text", confidence=0.9,
            xmin=int(rect[0]), ymin=int(rect[1]),
            xmax=int(rect[2]), ymax=int(rect[3]),
        )
    return None


_ANNOTATION_WORDS = (
    "Vout", "Vin", "node A", "node B", "Fig. 1", "R eq", "I1", "KVL",
    "loop 1", "mesh 2", "Vs", "out", "in+", "ckt",
)


def draw_annotation_text(
    img: np.ndarray, box: BBox, rng: np.random.Generator
) -> None:
    """Fill a `text`-class GT box with plausible schematic annotation
    ink (clipped to the box interior)."""
    h, w = img.shape[:2]
    x0, y0 = _clip(box.xmin, 0, w - 1), _clip(box.ymin, 0, h - 1)
    x1, y1 = _clip(box.xmax, 0, w), _clip(box.ymax, 0, h)
    bh, bw = y1 - y0, x1 - x0
    if bh < 6 or bw < 8:
        return
    word = str(rng.choice(_ANNOTATION_WORDS))
    size = max(8, min(16, bh - 2))
    font = load_font(size)
    l, t, _r, _b = font.getbbox(word)
    font.draw(img[y0:y1, x0:x1], 1 - l, 1 - t, word)


#: ASCII value grammar per class family (what the stage-2 VLM reads and
#: fix_netlist consumes — src/utils.py:42-99 metric-prefix rules).
VALUE_GRAMMAR = {
    "resistor": ("R", ["", "k", "M"], ""),
    "resistor.adjustable": ("R", ["", "k"], ""),
    "capacitor": ("C", ["p", "n", "u"], ""),
    "capacitor.unpolarized": ("C", ["p", "n", "u"], ""),
    "capacitor.polarized": ("C", ["u", "m"], ""),
    "inductor": ("L", ["u", "m"], ""),
    "voltage.dc": ("V", [""], ""),
    "voltage.battery": ("V", [""], ""),
    "current.dc": ("I", ["m", "u", ""], ""),
}


def random_value(cls: str, rng: np.random.Generator) -> Optional[str]:
    """A random plausible printed value for `cls` (None = unlabeled)."""
    if cls == "voltage.ac":
        mag = int(rng.integers(1, 12))
        phase = int(rng.choice([-90, -45, 0, 45, 90]))
        return f"{mag}:{phase}"
    g = VALUE_GRAMMAR.get(cls)
    if g is None:
        return None
    _, prefixes, _ = g
    n = int(rng.choice([1, 2, 4, 5, 10, 22, 47, 100, 220, 470]))
    return f"{n}{rng.choice(prefixes)}"


def render_schematic(
    mask: np.ndarray,
    boxes: Sequence[BBox],
    rng: np.random.Generator,
    with_values: bool = True,
    value_overrides: Optional[dict] = None,
    direction_overrides: Optional[dict] = None,
    base_image: Optional[np.ndarray] = None,
):
    """Class-distinct render of a synthetic circuit.

    Returns (image_rgb, values_by_uid, directions_by_uid, text_boxes):
    wires black on white, per-class glyphs inside boxes, printed values
    adjacent (as detectable `text` boxes), and the sampled polarity
    direction per polarized component (ground truth for a direction
    reader).

    value_overrides / direction_overrides: {persistent_uid: value/dir}
    pin what gets printed instead of sampling — the full-model eval set
    renders the exact values/directions its canned stage-1/2 VLM labels
    assert, so a pixels-only reader reproduces the pinned netlists.

    base_image: pre-inked wires (e.g. hand-drawn strokes from
    eval/handdrawn.py) — glyphs/values draw on top of it instead of the
    crisp `mask > 0` rasterization."""
    if base_image is not None:
        img = base_image
    else:
        img = np.full((mask.shape[0], mask.shape[1], 3), 255, np.uint8)
        img[mask > 0] = 0
    values: dict = {}
    directions: dict = {}
    text_boxes: list[BBox] = []
    taken: list = [
        (b.xmin, b.ymin, b.xmax, b.ymax) for b in boxes
    ]
    for b in boxes:
        if b.class_name in ("text", "explanatory"):
            # Layout-supplied annotation boxes arrive ink-free; fill them
            # with plausible label text so `text` is a learnable detector
            # class (a blank GT region is pure label noise) — ink stays
            # inside the box, so topology subtraction is unchanged.
            draw_annotation_text(img, b, rng)
            continue
        if b.class_name == "junction":
            # solder-dot on the wire (junction boxes are preserved during
            # topology subtraction, so the extra ink only thickens the
            # already-connected crossing locally)
            ccx, ccy = (b.xmin + b.xmax) // 2, (b.ymin + b.ymax) // 2
            r = max(2, min(b.width, b.height) // 3)
            yy, xx = np.mgrid[
                max(0, ccy - r) : min(img.shape[0], ccy + r + 1),
                max(0, ccx - r) : min(img.shape[1], ccx + r + 1),
            ]
            img[yy.ravel(), xx.ravel()] = np.where(
                ((yy - ccy) ** 2 + (xx - ccx) ** 2 <= r * r).ravel()[:, None],
                0, img[yy.ravel(), xx.ravel()],
            )
            continue
        if b.class_name in ("crossover", "circuit"):
            continue
        d = None
        if b.class_name in ("voltage.dc", "voltage.battery", "voltage.ac",
                            "current.dc", "voltage.dependent",
                            "current.dependent") or \
                b.class_name.startswith("diode"):
            d = (direction_overrides or {}).get(b.persistent_uid)
            if d is None:
                d = str(rng.choice(["UP", "DOWN"] if b.height >= b.width
                                   else ["LEFT", "RIGHT"]))
            directions[b.persistent_uid] = d
        draw_glyph(img, b, direction=d, rng=rng)
        if with_values:
            if value_overrides is not None and b.persistent_uid in value_overrides:
                v = value_overrides[b.persistent_uid]
            else:
                v = random_value(b.class_name, rng)
            if v is not None:
                tb = draw_value_text(img, b, v, taken)
                if tb is not None:
                    values[b.persistent_uid] = v
                    text_boxes.append(tb)
    return img, values, directions, text_boxes
