"""Polar phasor plots of an AC solution, drawn without matplotlib.

Counterpart of the JAX package's `sim/plots.py` (reference
src/spice_simulator.py:264-299), which draws with matplotlib's Agg: a
figure of `figsize` inches at 100 dpi holding two polar axes, voltages
left and currents right, one ray from the centre a phasor with a circle
marker at its tip, in the colour cycle C0, C1, … of each axes, `rmax`
1.2 × the largest magnitude (1 when every one is 0), grids, titles and a
legend. This module reproduces the geometry matplotlib 3.10 gives that
figure and draws it with core/draw.py:

  * the axes' centres and radius follow `tight_layout` on the two
    subplots: the vertical layout is fixed by the titles and the 90° and
    270° labels, the horizontal one by the 180° and 0° labels and, where
    it reaches further right, each axes' outermost radial tick label
    (DejaVu Sans advances at 10 pt), measured at the layout before the
    adjustment, as tight_layout measures;
  * the radial ticks are matplotlib's own rule, ported: `AutoLocator`
    (MaxNLocator, steps 1, 2, 2.5, 5, 10, nine bins at this size) under
    the polar `RadialLocator` (ticks above 0) and drawn up to rmax, with
    `ScalarFormatter`'s labels;
  * the legend takes matplotlib's 'best' place: the first of its nine
    candidate corners and sides that the rays cross least.

Text is drawn with the Hershey sizes of core/hershey.py, not DejaVu Sans,
so its glyph pixels are not matplotlib's; positions, ticks, colours and
rays are matplotlib's (tests/test_torch_port_phasor.py holds them).
"""
from __future__ import annotations

import dataclasses
import math
import numpy as np

from ..core import draw
from .mna import ACSolution

DPI = 100
#: matplotlib's tab10 colour cycle, C0 … C9
TAB10 = ((0x1F, 0x77, 0xB4), (0xFF, 0x7F, 0x0E), (0x2C, 0xA0, 0x2C), (0xD6, 0x27, 0x28),
         (0x94, 0x67, 0xBD), (0x8C, 0x56, 0x4B), (0xE3, 0x77, 0xC2), (0x7F, 0x7F, 0x7F),
         (0xBC, 0xBD, 0x22), (0x17, 0xBE, 0xCF))
GRID = (0xB0, 0xB0, 0xB0)
#: DejaVu Sans advances (units of 2048 to the em) of the tick labels' characters
_DEJAVU = {**{d: 1303 for d in "0123456789"}, ".": 651, "−": 1716}
_FONT_PX = 10 / 72 * DPI  # 10 pt
#: measured on matplotlib 3.10's figure before tight_layout, in pixels
#: beyond the circle: the right end of the "0°" label, the left end of
#: "180°", an angular label's centre, the bottom of "270°", and the
#: title's bottom and height
_ZERO_REACH, _180_REACH, _LABEL_GAP, _270_REACH = 27.32, 36.19, 19.45, 26.44
_TITLE_GAP, _TITLE_H = 30.78, 18.0
_PAD = 1.08 * _FONT_PX  # tight_layout's pad


@dataclasses.dataclass
class PolarAxes:
    """One axes as drawn: centre (x, y) and radius in pixels, y down."""
    title: str
    center: tuple[float, float]
    radius: float
    rmin: float  # the r at the centre: 0, or below it where every phasor is 0
    rmax: float
    ticks: list[float]
    tick_labels: list[str]
    rays: list[tuple[str, float, float]]  # (label, magnitude, angle in radians)
    legend: bool

    def point(self, r: float, theta: float) -> tuple[float, float]:
        s = (r - self.rmin) / (self.rmax - self.rmin) * self.radius
        return self.center[0] + s * math.cos(theta), self.center[1] - s * math.sin(theta)


# ------------------------------------------------------ matplotlib's ticks
def _scale_range(vmin: float, vmax: float, n: int = 1, threshold: int = 100):
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    offset = 0.0
    if abs(meanv) / dv >= threshold:
        offset = math.copysign(10 ** (math.log10(abs(meanv)) // 1), meanv)
    return 10 ** (math.log10(dv / n) // 1), offset


def _closeto(ms: float, edge: float, step: float, offset: float) -> bool:
    if offset > 0:
        tol = min(0.4999, max(1e-10, 10 ** (np.log10(offset / step) - 12)))
    else:
        tol = 1e-10
    return abs(ms - edge) < tol


def max_n_ticks(vmin: float, vmax: float, nbins: int = 9,
                steps=(1, 2, 2.5, 5, 10), min_n_ticks: int = 2) -> np.ndarray:
    """MaxNLocator(nbins, steps).tick_values(vmin, vmax) of matplotlib
    3.10, for vmin < vmax (no view this module draws is singular)."""
    st = np.asarray(steps, float)
    extended = np.concatenate([0.1 * st[:-1], st, [10 * st[1]]])
    scale, offset = _scale_range(vmin, vmax, nbins)
    _vmin, _vmax = vmin - offset, vmax - offset
    cand = extended * scale
    raw_step = (_vmax - _vmin) / nbins
    large = cand >= raw_step
    istep = int(np.nonzero(large)[0][0]) if large.any() else len(cand) - 1
    for step in cand[:istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        d, m = divmod(_vmin - best_vmin, step)
        low = d + 1 if _closeto(m / step, 1, step, abs(offset)) else d
        d, m = divmod(_vmax - best_vmin, step)
        high = d if _closeto(m / step, 0, step, abs(offset)) else d + 1
        ticks = np.arange(low, high + 1) * step + best_vmin
        if ((ticks <= _vmax) & (ticks >= _vmin)).sum() >= min_n_ticks:
            break
    return ticks + offset


def radial_ticks(rmax: float, rmin: float = 0.0) -> np.ndarray:
    """The polar axes' radial ticks over (rmin, rmax): AutoLocator's, those
    above rmin, the r at the centre (RadialLocator) — the drawn ones are
    those up to rmax."""
    ticks = max_n_ticks(rmin, rmax)
    return ticks[ticks > rmin]


def _visible(ticks: np.ndarray, rmax: float, rmin: float = 0.0) -> np.ndarray:
    """The ticks an axis draws: inside the view, with matplotlib's slop."""
    eps = 1e-10 * (rmax - rmin)
    return ticks[(ticks >= rmin - eps) & (ticks <= rmax + eps)]


def tick_labels(ticks: np.ndarray, rmax: float, rmin: float = 0.0) -> tuple[list[str], int]:
    """ScalarFormatter's labels of `ticks` (all the locator's) and the
    power of ten it factors out (powerlimits -5, 6)."""
    vis = np.abs(_visible(ticks, rmax, rmin))
    oom = 0
    if len(vis) and vis.max() != 0:
        o = math.floor(math.log10(vis.max()))
        if o <= -5 or o >= 6:
            oom = o
    locs = np.asarray(ticks if len(ticks) >= 2 else [*ticks, rmin, rmax]) / 10.0 ** oom
    loc_range = np.ptp(locs) or np.max(np.abs(locs)) or 1
    if len(ticks) < 2:
        locs = locs[:-2]
    loc_range_oom = int(math.floor(math.log10(loc_range)))
    sigfigs = max(0, 3 - loc_range_oom)
    thresh = 1e-3 * 10 ** loc_range_oom
    while sigfigs >= 0:
        if np.abs(locs - np.round(locs, decimals=sigfigs)).max() < thresh:
            sigfigs -= 1
        else:
            break
    sigfigs += 1
    return [(f"%1.{sigfigs}f" % v).replace("-", "−") for v in locs], oom


# ------------------------------------------------------------- the layout
def _text_width(s: str) -> float:
    return sum(_DEJAVU.get(c, 1303) for c in s) / 2048 * _FONT_PX


def _radial_right(ticks, labels, rmin, rmax, radius) -> float:
    """How far right of the centre the outermost drawn radial label ends."""
    ends = [math.cos(math.radians(22.5)) * radius * (t - rmin) / (rmax - rmin) + _text_width(lab)
            for t, lab in zip(_visible(ticks, rmax, rmin), labels)]
    return max(ends, default=0.0)


def layout(width: float, height: float, right_reach: tuple[float, float]):
    """((centre of each axes), radius) after tight_layout, from how far
    right of its centre each axes' outermost radial label reaches at the
    initial layout (0 where it does not)."""
    # matplotlib's default subplot parameters: the two slots before tight_layout
    left, right, bottom, top, wspace = 0.125, 0.9, 0.11, 0.88, 0.2
    slot_w = (right - left) * width / (2 + wspace)
    x0 = (left * width, left * width + slot_w * (1 + wspace))
    cx = (x0[0] + slot_w / 2, x0[1] + slot_w / 2)
    r0 = min(slot_w, (top - bottom) * height) / 2
    reach = [max(r0 + _ZERO_REACH, rr) for rr in right_reach]
    ml = max(x0[0] - (cx[0] - r0 - _180_REACH), 0) + _PAD
    mr = max(cx[1] + reach[1] - (x0[1] + slot_w), 0) + _PAD
    hs = (cx[0] + reach[0] - (x0[0] + slot_w)) + (x0[1] - (cx[1] - r0 - _180_REACH)) + _PAD
    h_axes = (width - ml - mr - hs) / 2
    # vertically (y up): the titles above and the 270° labels below
    cy0 = (bottom + top) / 2 * height
    mt = max(cy0 + r0 + _TITLE_GAP + _TITLE_H - top * height, 0) + _PAD
    mb = max(bottom * height - (cy0 - r0 - _270_REACH), 0) + _PAD
    v_axes = height - mt - mb
    cy = mt + v_axes / 2  # from the top
    return ((ml + h_axes / 2, cy), (ml + 1.5 * h_axes + hs, cy)), min(h_axes, v_axes) / 2


def phasor_axes(solution: ACSolution, figsize=(12, 5)) -> list[PolarAxes]:
    """The two axes of `phasor_plot`, laid out as matplotlib lays them."""
    width, height = figsize[0] * DPI, figsize[1] * DPI
    specs = []
    volts = [(f"V({n})", abs(v), float(np.angle(v))) for n, v in solution.node_voltages.items()
             if str(n) != "0"]
    amps = [(str(b), abs(v), float(np.angle(v))) for b, v in solution.branch_currents.items()]
    for title, rays, legend in (("Voltage Phasors", volts, bool(solution.node_voltages)),
                                ("Current Phasors", amps, bool(solution.branch_currents))):
        top = max([m for _l, m, _a in rays], default=0.0)
        rmax = top * 1.2 if top > 0 else 1
        # phasors all of magnitude 0 autoscale the view's bottom below 0:
        # (-0.05, 0.05) for the singular data, widened by the 5 % margin
        rmin = -0.055 if rays and top == 0 else 0.0
        ticks = radial_ticks(rmax, rmin)
        labels, _oom = tick_labels(ticks, rmax, rmin)
        keep = [i for i, t in enumerate(ticks) if t in _visible(ticks, rmax, rmin)]
        specs.append((title, rays, legend and bool(rays), rmin, rmax,
                      [float(ticks[i]) for i in keep], [labels[i] for i in keep]))
    r0 = min((0.9 - 0.125) * width / 2.2, (0.88 - 0.11) * height) / 2
    reach = [_radial_right(np.asarray(ticks), labels, rmin, rmax, r0)
             for _t, _r, _l, rmin, rmax, ticks, labels in specs]
    centres, radius = layout(width, height, tuple(reach))
    return [PolarAxes(title, c, radius, rmin, rmax, ticks, labels, rays, legend)
            for (title, rays, legend, rmin, rmax, ticks, labels), c in zip(specs, centres)]


# ----------------------------------------------------------------- drawing
def _text(img, s: str, x: float, y: float, ha="center", va="center", big=False) -> None:
    """Hershey text anchored as matplotlib anchors it; '°' drawn as a ring."""
    plain = s.replace("°", "").replace("−", "-")
    scale, t = (0.9, 2) if big else (0.5, 1)
    (w, h), _b = draw.get_text_size(plain, scale, t) if plain else ((0, 0), 0)
    ring = 5 if "°" in s else 0
    x0 = {"left": x, "center": x - (w + ring) / 2, "right": x - w - ring}[ha]
    y0 = {"bottom": y, "center": y + h / 2, "top": y + h}[va]
    if plain:
        draw.put_text(img, plain, (int(round(x0)), int(round(y0))), scale, (0, 0, 0), t)
    if ring:
        cx, cy = int(round(x0 + w + 2)), int(round(y0 - h + 2))
        ring = [(-1, -2), (1, -2), (2, -1), (2, 1), (1, 2), (-1, 2), (-2, 1), (-2, -1)]
        draw.polylines(img, [(cx + dx, cy + dy) for dx, dy in ring], True, (0, 0, 0), 1)


def _circle(img, c, r, color, thickness=1) -> None:
    n = max(64, int(r))
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([c[0] + r * np.cos(a), c[1] - r * np.sin(a)], 1)
    draw.polylines(img, np.rint(pts).astype(np.int64), True, color, thickness)


def _legend_box(ax: PolarAxes):
    """(x, y, w, h) of matplotlib's 'best' legend place for these rays."""
    fs = _FONT_PX
    entries = [lab for lab, _m, _a in ax.rays]
    tw = max(draw.get_text_size(e, 0.5, 1)[0][0] for e in entries)
    w = 2 * 0.4 * fs + 2.0 * fs + 0.8 * fs + tw
    h = 2 * 0.4 * fs + len(entries) * fs + (len(entries) - 1) * 0.5 * fs
    cx, cy, r = ax.center[0], ax.center[1], ax.radius
    pad = 0.5 * fs
    L, R, T, B = cx - r + pad, cx + r - pad - w, cy - r + pad, cy + r - pad - h
    mx, my = cx - w / 2, cy - h / 2
    # 'upper right', 'upper left', 'lower left', 'lower right', 'right',
    # 'center left', 'center right', 'lower center', 'upper center', 'center'
    places = [(R, T), (L, T), (L, B), (R, B), (R, my), (L, my), (R, my), (mx, B), (mx, T),
              (mx, my)]
    segs = [((cx, cy), ax.point(m, a)) for _l, m, a in ax.rays]
    best = None
    for i, (x, y) in enumerate(places):
        inside = lambda p: x <= p[0] <= x + w and y <= p[1] <= y + h  # noqa: E731
        bad = sum(inside(p) for s in segs for p in s)
        bad += sum(_crosses(s, (x, y, x + w, y + h)) for s in segs)
        if best is None or bad < best[0]:
            best = (bad, (x, y))
        if bad == 0:
            break
    return (*best[1], w, h)


def _crosses(seg, box) -> bool:
    """Whether a segment meets a box (Liang–Barsky)."""
    (x0, y0), (x1, y1) = seg
    t0, t1 = 0.0, 1.0
    dx, dy = x1 - x0, y1 - y0
    for p, q in ((-dx, x0 - box[0]), (dx, box[2] - x0), (-dy, y0 - box[1]), (dy, box[3] - y0)):
        if p == 0:
            if q < 0:
                return False
            continue
        t = q / p
        if p < 0:
            t0 = max(t0, t)
        else:
            t1 = min(t1, t)
        if t0 > t1:
            return False
    return True


def _draw_axes(img, ax: PolarAxes) -> None:
    cx, cy = ax.center
    for t in ax.ticks:
        _circle(img, ax.center, math.dist(ax.point(t, 0), ax.center), GRID)
    for k in range(8):
        a = k * math.pi / 4
        end = (cx + ax.radius * math.cos(a), cy - ax.radius * math.sin(a))
        draw.line(img, (int(round(cx)), int(round(cy))), tuple(int(round(v)) for v in end), GRID)
    for i, (_lab, m, a) in enumerate(ax.rays):
        col = TAB10[i % 10]
        tip = tuple(int(round(v)) for v in ax.point(m, a))
        draw.line(img, (int(round(cx)), int(round(cy))), tip, col, 3)
        draw.circle(img, tip, 4, col)
    _circle(img, ax.center, ax.radius, (0, 0, 0))
    for k in range(8):
        a = k * math.pi / 4
        d = ax.radius + _LABEL_GAP
        _text(img, f"{45 * k}°", cx + d * math.cos(a), cy - d * math.sin(a))
    c, s = math.cos(math.radians(22.5)), math.sin(math.radians(22.5))
    for t, lab in zip(ax.ticks, ax.tick_labels):
        d = math.dist(ax.point(t, 0), ax.center)
        _text(img, lab, cx + d * c, cy - d * s, ha="left", va="bottom")
    _text(img, ax.title, cx, cy - ax.radius - _TITLE_GAP, va="bottom")
    if ax.legend:
        x, y, w, h = _legend_box(ax)
        xi, yi, xe, ye = int(round(x)), int(round(y)), int(round(x + w)), int(round(y + h))
        box = img[max(yi, 0):ye, max(xi, 0):xe]
        box[:] = (box.astype(np.int32) * 2 // 10 + 255 * 8 // 10).astype(np.uint8)  # alpha 0.8
        draw.rectangle(img, (xi, yi), (xe, ye), (0xCC, 0xCC, 0xCC), 1)
        fs = _FONT_PX
        for i, (lab, _m, _a) in enumerate(ax.rays):
            col = TAB10[i % 10]
            ly = y + 0.4 * fs + i * 1.5 * fs + fs / 2
            x1 = x + 0.4 * fs
            draw.line(img, (int(round(x1)), int(round(ly))), (int(round(x1 + 2 * fs)),
                                                            int(round(ly))), col, 3)
            draw.circle(img, (int(round(x1 + fs)), int(round(ly))), 4, col)
            _text(img, lab, x1 + 2.8 * fs, ly, ha="left")


def phasor_plot(solution: ACSolution, figsize=(12, 5)) -> np.ndarray:
    """Voltage and current phasor diagrams as an RGB uint8 array of
    figsize × 100 dpi, (500, 1200, 3) by default."""
    img = np.full((int(figsize[1] * DPI), int(figsize[0] * DPI), 3), 255, np.uint8)
    for ax in phasor_axes(solution, figsize):
        _draw_axes(img, ax)
    return img
