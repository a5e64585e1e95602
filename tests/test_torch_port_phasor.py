"""The port's phasor plot (sim/plots.py, no matplotlib) against the JAX
package's `phasor_plot` (matplotlib 3.10's Agg) on the CPU, for the RC,
RL and RLC AC netlists of the simulation tests and a seeded sweep of
magnitudes and angles:

  * equal: the image's shape, the radial tick values each axes draws, the
    titles, and the legend entries in their order;
  * within 2 px: each axes' centre and radius (from matplotlib's
    transforms) and each ray's end point;
  * within ±2 per channel: a ray's colour at its midpoint, the tab10
    colour of its place in the cycle, in both images.

Glyph pixels are not compared: the port draws Hershey text, not DejaVu
Sans.
"""
import math

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from circuitvision_tpu.sim import plots as jplots  # noqa: E402
from circuitvision_tpu.sim.mna import ACSolution as JAC  # noqa: E402
from circuitvision_tpu.sim.mna import solve_ac as jsolve_ac  # noqa: E402
from circuitvision_tpu_torch.sim import plots  # noqa: E402
from circuitvision_tpu_torch.sim.mna import ACSolution, solve_ac  # noqa: E402

NETLISTS = {
    "RC": "V1 1 0 0 AC 1 0\nR1 1 2 1k\nC1 2 0 1u",
    "RL": "V1 1 0 0 AC 1 0\nR1 1 2 1k\nL1 2 0 1",
    "RLC": "V1 1 0 0 AC 10 30\nR1 1 2 100\nL1 2 3 0.1\nC1 3 0 10u",
}


def _matplotlib(sol):
    """The JAX plot and, from its figure, each axes' centre (y down),
    radius, drawn radial ticks, title, legend texts and ray tips."""
    figs = []
    close = plt.close
    plt.close = figs.append
    try:
        img = jplots.phasor_plot(sol)
    finally:
        plt.close = close
    fig = figs[0]
    h = fig.bbox.height
    renderer = fig.canvas.get_renderer()
    axes = []
    for ax in fig.axes:
        c = ax.transAxes.transform((0.5, 0.5))  # the r at the centre is rmin, not always 0
        e = ax.transData.transform((0, ax.get_rmax()))
        lo, hi = ax.get_ylim()
        ticks = [float(t) for t in ax.yaxis.get_majorticklocs() if t <= hi * (1 + 1e-10)]
        tips = []
        for line in ax.lines:
            (a0, a1), (r0, r1) = line.get_data()
            x, y = ax.transData.transform((a1, r1))
            tips.append((x, h - y))
        legend = ax.get_legend()
        # what matplotlib draws over the rays: the radial labels and the legend
        over = [t.get_window_extent(renderer) for t, v in
                zip(ax.yaxis.get_ticklabels(), ax.yaxis.get_majorticklocs()) if v <= hi]
        over += [legend.get_window_extent(renderer)] if legend else []
        axes.append(dict(center=(c[0], h - c[1]), radius=float(np.hypot(*(e - c))), ticks=ticks,
                         title=ax.get_title(), tips=tips,
                         over=[(b.x0, h - b.y1, b.x1, h - b.y0) for b in over],
                         legend=[t.get_text() for t in legend.get_texts()] if legend else []))
    close(fig)
    return img, axes


def _solutions():
    sols = {name: jsolve_ac(text, 60.0) for name, text in NETLISTS.items()}
    rng = np.random.default_rng(26)
    for k in range(12):
        vm, im = 10 ** rng.uniform(-7, 7), 10 ** rng.uniform(-7, 7)
        n = int(rng.integers(1, 5))
        volts = {str(i + 1): vm * rng.uniform(0.05, 1) * np.exp(1j * rng.uniform(-3.1, 3.1))
                 for i in range(n)}
        if k % 4 == 0:
            volts["0"] = 0j  # ground: skipped, as in JAX
        amps = {f"V{i + 1}": im * rng.uniform(0.05, 1) * np.exp(1j * rng.uniform(-3.1, 3.1))
                for i in range(int(rng.integers(1, 4)))}
        sols[f"sweep{k}"] = JAC(volts, amps, 60.0)
    sols["empty"] = JAC({}, {}, 60.0)
    sols["zero"] = JAC({"1": 0j}, {"V1": 0j}, 60.0)
    return sols


SOLUTIONS = _solutions()


def _port(sol):
    return ACSolution(dict(sol.node_voltages), dict(sol.branch_currents), sol.frequency_hz)


@pytest.mark.parametrize("name", sorted(SOLUTIONS))
def test_phasor_plot_matches_matplotlib(name):
    sol = SOLUTIONS[name]
    want_img, want = _matplotlib(sol)
    got_img = plots.phasor_plot(_port(sol))
    got = plots.phasor_axes(_port(sol))
    assert got_img.shape == want_img.shape == (500, 1200, 3) and got_img.dtype == np.uint8
    for w, g in zip(want, got):
        assert g.title == w["title"]
        assert len(g.ticks) == len(w["ticks"])
        assert np.allclose(g.ticks, w["ticks"], rtol=1e-12, atol=0)
        assert ([lab for lab, _m, _a in g.rays] if g.legend else []) == w["legend"]
        assert abs(g.center[0] - w["center"][0]) <= 2 and abs(g.center[1] - w["center"][1]) <= 2
        assert abs(g.radius - w["radius"]) <= 2
        assert len(g.rays) == len(w["tips"])
        ends = [g.point(m, a) for _lab, m, a in g.rays]
        over = w["over"] + _port_overlays(g)
        for i, (end, tip) in enumerate(zip(ends, w["tips"])):
            assert math.dist(end, tip) <= 2
            mid = _mid(g.center, end)
            if math.dist(end, g.center) < 16 or any(
                    _near_segment(mid, g.center, e, 7) for e in ends[i + 1:]) or any(
                    x0 - 3 <= mid[0] <= x1 + 3 and y0 - 3 <= mid[1] <= y1 + 3
                    for x0, y0, x1, y1 in over):
                continue  # a ray too short, or one, a label or the legend drawn over its middle
            colour = np.asarray(plots.TAB10[i % 10])
            # Agg's pixel (i, j) covers [i, i + 1) × [j, j + 1); the port
            # draws its lines through the rounded points
            for img, c, e, snap in ((want_img, w["center"], tip, math.floor),
                                    (got_img, g.center, end, round)):
                mx, my = _mid(c, e, snap)
                assert np.abs(img[my, mx].astype(int) - colour).max() <= 2, (name, i)


def _port_overlays(ax):
    """The boxes of the port's radial labels and legend, (x0, y0, x1, y1)."""
    boxes = []
    c, s = math.cos(math.radians(22.5)), math.sin(math.radians(22.5))
    for t, lab in zip(ax.ticks, ax.tick_labels):
        d = math.dist(ax.point(t, 0), ax.center)
        (tw, th), _b = plots.draw.get_text_size(lab.replace("−", "-"), 0.5, 1)
        x, y = ax.center[0] + d * c, ax.center[1] - d * s
        boxes.append((x, y - th, x + tw, y))
    if ax.legend:
        x, y, w, h = plots._legend_box(ax)
        boxes.append((x, y, x + w, y + h))
    return boxes


def _mid(a, b, snap=round):
    return int(snap((a[0] + b[0]) / 2)), int(snap((a[1] + b[1]) / 2))


def _near_segment(p, a, b, d):
    """Whether point p lies within d pixels of the segment ab."""
    a, b, p = np.asarray(a, float), np.asarray(b, float), np.asarray(p, float)
    t = np.clip(np.dot(p - a, b - a) / max(np.dot(b - a, b - a), 1e-12), 0, 1)
    return np.linalg.norm(a + t * (b - a) - p) <= d


def test_the_port_solution_draws_the_same_as_jax_solves_it():
    """The port's own solve_ac feeds the plot the JAX solver's phasors."""
    for text in NETLISTS.values():
        a, b = _port(jsolve_ac(text, 60.0)), solve_ac(text, 60.0)
        assert a.node_voltages.keys() == b.node_voltages.keys()
        assert np.array_equal(plots.phasor_plot(a), plots.phasor_plot(b))


def test_tick_locator_equals_matplotlib():
    from matplotlib.ticker import MaxNLocator, ScalarFormatter
    rng = np.random.default_rng(0)
    loc = MaxNLocator(nbins=9, steps=[1, 2, 2.5, 5, 10])
    rmaxes = [1, 1.2, 9, 12.806, 0.000504, 4800, 3e-7, 2.2e8] + list(10 ** rng.uniform(-9, 9, 40))
    for rmax in rmaxes:
        want = loc.tick_values(0, rmax)
        assert np.array_equal(plots.max_n_ticks(0.0, rmax), want)
        ticks = plots.radial_ticks(rmax)
        fmt = ScalarFormatter()
        fig, ax = plt.subplots()
        ax.set_ylim(0, rmax)
        fmt.set_axis(ax.yaxis)
        want_labels = fmt.format_ticks(ticks)
        plt.close(fig)
        labels, oom = plots.tick_labels(ticks, rmax)
        assert labels == want_labels and oom == fmt.orderOfMagnitude
