"""DC/AC analysis orchestration + result formatting.

The JAX package's `sim/engine.py`: perform_dc_spice_analysis /
perform_ac_spice_analysis (src/spice_simulator.py:9-117, 119-309)
without the Streamlit rendering — the same pre-processing (reactance
commenting for DC; AC source/C/L value rewriting), the same result
formats ("x.xxxV" / "x.xxxmA" for DC, "mag ∠ phase° V/A" for AC),
returned as plain dicts.

Solver backend: `SimConfig.prefer_native` takes the C++ solver
(sim/native_backend.py), built with g++ at first use; a build or load
that fails raises out of the perform_* call. The JAX package's engine
swallows that failure and solves with numpy instead (its `_backend`);
the port does not hide a failed native build. `prefer_native=False`
takes the numpy solver in mna.py. The two agree to round-off (on a
diode's leakage current, to ~1e-9 V), and their formatted strings are
the same on the eval netlists.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..core.config import SimConfig
from ..core.types import NetlistLine
from ..netlist.values import preprocess_netlist_for_dc, rewrite_value_for_ac
from . import mna
from .mna import SimulationError  # re-export for callers


@dataclasses.dataclass
class DCResult:
    ok: bool
    node_voltages: dict[str, str] = dataclasses.field(default_factory=dict)
    branch_currents: dict[str, str] = dataclasses.field(default_factory=dict)
    raw: Optional[mna.OperatingPoint] = None
    deck: str = ""
    error: Optional[str] = None


@dataclasses.dataclass
class ACResult:
    ok: bool
    node_voltages: dict[str, str] = dataclasses.field(default_factory=dict)
    branch_currents: dict[str, str] = dataclasses.field(default_factory=dict)
    raw: Optional[mna.ACSolution] = None
    deck: str = ""
    error: Optional[str] = None


def _backend(cfg: SimConfig):
    """(solve_dc, solve_ac) of the backend `cfg` asks for; the native one
    is built and loaded here, and raises if that fails."""
    if cfg.prefer_native:
        from . import native_backend

        native_backend.load_library()
        return native_backend.solve_dc_native, native_backend.solve_ac_native
    return mna.solve_dc, mna.solve_ac


def perform_dc_analysis(
    netlist_text: str, cfg: Optional[SimConfig] = None
) -> DCResult:
    """DC operating point on raw netlist text (the editable-netlist path,
    src/spice_simulator.py:9)."""
    cfg = cfg or SimConfig()
    if not netlist_text or not netlist_text.strip():
        return DCResult(ok=False, error="Netlist is empty.")
    dc_safe = preprocess_netlist_for_dc(netlist_text)
    deck = f".title detected_circuit_dc\n{dc_safe}\n.end\n"
    solve_dc, _ = _backend(cfg)
    try:
        op = solve_dc(
            dc_safe,
            gmin=cfg.gmin,
            abstol=cfg.abstol,
            reltol=cfg.reltol,
            max_iters=cfg.max_newton_iters,
        )
    except Exception as e:
        return DCResult(ok=False, deck=deck, error=f"DC SPICE Analysis Error: {e}")
    volts = {k: f"{v:.3f}V" for k, v in op.node_voltages.items()}
    amps = {k: f"{i * 1000:.3f}mA" for k, i in op.branch_currents.items()}
    return DCResult(ok=True, node_voltages=volts, branch_currents=amps, raw=op, deck=deck)


def perform_ac_analysis(
    netlist: Sequence[NetlistLine],
    frequency_hz: float,
    cfg: Optional[SimConfig] = None,
) -> ACResult:
    """Single-frequency AC analysis on structured netlist lines
    (src/spice_simulator.py:119-309): rewrites source phasors and C/L
    reactances at the given frequency, then solves."""
    cfg = cfg or SimConfig()
    body_lines = []
    for line in netlist:
        if line.class_name == "gnd":
            continue
        rewritten = dataclasses.replace(line)
        rewritten.value = rewrite_value_for_ac(
            line.component_type or "", line.value, frequency_hz
        )
        text = rewritten.stringify()
        if text:
            body_lines.append(text)
    body = "\n".join(body_lines)
    deck = (
        f".title detected_circuit_ac\n{body}\n"
        f"* .ac lin 1 {frequency_hz} {frequency_hz}\n.end\n"
    )
    if not body.strip():
        return ACResult(ok=False, deck=deck, error="Netlist for AC analysis is empty.")
    _, solve_ac = _backend(cfg)
    try:
        sol = solve_ac(body, frequency_hz)
    except Exception as e:
        return ACResult(ok=False, deck=deck, error=f"AC SPICE Analysis Error: {e}")
    volts = {
        k: f"{abs(v):.3f} ∠ {np.angle(v, deg=True):.2f}° V"
        for k, v in sol.node_voltages.items()
    }
    amps = {
        k: f"{abs(i):.3f} ∠ {np.angle(i, deg=True):.2f}° A"
        for k, i in sol.branch_currents.items()
    }
    return ACResult(ok=True, node_voltages=volts, branch_currents=amps, raw=sol, deck=deck)


def perform_ac_analysis_text(
    netlist_text: str, frequency_hz: float, cfg: Optional[SimConfig] = None
) -> ACResult:
    """AC analysis directly on netlist text (values already rewritten or
    in 'dc AC mag phase' / reactance form)."""
    cfg = cfg or SimConfig()
    _, solve_ac = _backend(cfg)
    deck = (
        f".title detected_circuit_ac\n{netlist_text}\n"
        f"* .ac lin 1 {frequency_hz} {frequency_hz}\n.end\n"
    )
    try:
        sol = solve_ac(netlist_text, frequency_hz)
    except Exception as e:
        return ACResult(ok=False, deck=deck, error=f"AC SPICE Analysis Error: {e}")
    volts = {
        k: f"{abs(v):.3f} ∠ {np.angle(v, deg=True):.2f}° V"
        for k, v in sol.node_voltages.items()
    }
    amps = {
        k: f"{abs(i):.3f} ∠ {np.angle(i, deg=True):.2f}° A"
        for k, i in sol.branch_currents.items()
    }
    return ACResult(ok=True, node_voltages=volts, branch_currents=amps, raw=sol, deck=deck)
