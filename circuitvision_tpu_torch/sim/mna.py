"""Modified nodal analysis: DC operating point + single-frequency AC.

The JAX package's `sim/mna.py`, copied: the replacement for the
reference's libngspice/PySpice path (src/spice_simulator.py:62-76,
206-219). Circuit simulation is sparse LU / Newton–Raphson on matrices
of a few rows — a host workload by design (SURVEY.md §2.3) — so it runs
in numpy on the host, never on the card, with the C++ solver
(sim/native/solver.cpp, sim/native_backend.py) behind the same
interface.

Supported elements (everything the pipeline emits):
  R           conductance stamp
  C           DC: open; AC: jωC admittance
  L           DC: 0 V branch (short); AC: 1/(jωL) admittance
  V           branch source (DC value; "dc AC mag phase" in AC)
  I           current injection
  D           Shockley diode via damped Newton (Is=1e-14, n=1, Vt=25.85mV)
  E/G/F/H     dependent sources (VCVS/VCCS/CCCS/CCVS), standard syntax

Analyses match the two the reference performs: `.op` and
`.ac lin 1 f f`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from .netlist_parse import Element, NetlistParseError, parse_netlist

_DIODE_IS = 1e-14
_DIODE_VT = 0.02585
#: SPICE pnjlim critical voltage: above it, junction-voltage steps are
#: limited logarithmically instead of clamped (clamping the voltage
#: inside the stamp makes Newton "converge" to a non-solution — the
#: linearization point stops moving while the extrapolated current is
#: orders of magnitude off the diode equation).
_DIODE_VCRIT = _DIODE_VT * math.log(_DIODE_VT / (math.sqrt(2.0) * _DIODE_IS))


def _pnjlim(vnew: float, vold: float) -> float:
    """SPICE3 junction-voltage limiting (ngspice devsup pnjlim)."""
    if vnew > _DIODE_VCRIT and abs(vnew - vold) > 2.0 * _DIODE_VT:
        if vold > 0.0:
            arg = 1.0 + (vnew - vold) / _DIODE_VT
            return (
                vold + _DIODE_VT * math.log(arg) if arg > 0 else _DIODE_VCRIT
            )
        return _DIODE_VT * math.log(vnew / _DIODE_VT)
    return vnew
_GMIN_DEFAULT = 1e-12


class SimulationError(ValueError):
    pass


@dataclasses.dataclass
class OperatingPoint:
    node_voltages: dict[str, float]
    branch_currents: dict[str, float]  # through V/L elements, Amperes


@dataclasses.dataclass
class ACSolution:
    node_voltages: dict[str, complex]
    branch_currents: dict[str, complex]
    frequency_hz: float


def _node_index(elements: Sequence[Element]) -> dict[str, int]:
    """Ground ('0'/'gnd') is eliminated; others get 0..N-1."""
    nodes: dict[str, int] = {}
    for el in elements:
        for n in (el.n1, el.n2):
            key = str(n)
            if key in ("0", "gnd", "GND"):
                continue
            if key not in nodes:
                nodes[key] = len(nodes)
    return nodes


def _branch_elements(elements: Sequence[Element], dc: bool) -> list[Element]:
    kinds = ("V", "L", "E", "H") if dc else ("V", "E", "H")
    return [el for el in elements if el.kind in kinds]


def solve_dc(
    netlist_text: str,
    gmin: float = _GMIN_DEFAULT,
    abstol: float = 1e-12,
    reltol: float = 1e-6,
    max_iters: int = 100,
) -> OperatingPoint:
    """DC operating point with Newton iteration for diodes."""
    elements = parse_netlist(netlist_text)
    if not elements:
        raise SimulationError("empty netlist")
    for el in elements:
        if el.kind not in ("R", "C", "L", "V", "I", "D", "E", "G", "F", "H"):
            raise SimulationError(
                f"unsupported element '{el.name}' of type {el.kind} "
                f"(DC analysis supports R, C, L, V, I, D, E, G, F, H)"
            )

    nodes = _node_index(elements)
    branches = _branch_elements(elements, dc=True)
    n, m = len(nodes), len(branches)
    size = n + m

    def idx(node: str) -> int:
        return nodes.get(str(node), -1)  # -1 = ground

    diodes = [el for el in elements if el.kind == "D"]
    branch_col = {el.name.lower(): n + k for k, el in enumerate(branches)}
    x = np.zeros(size)

    def ctrl_branch_col(el: Element) -> int:
        col = branch_col.get(el.ctrl_branch or "")
        if col is None:
            raise SimulationError(
                f"{el.name}: controlling source '{el.ctrl_branch}' not found"
            )
        return col

    #: per-diode linearization voltage, advanced by pnjlim each iteration
    vd_state = [0.0] * len(diodes)
    converged = not diodes
    for _ in range(max_iters if diodes else 1):
        diode_i = iter(range(len(diodes)))
        A = np.zeros((size, size))
        b = np.zeros(size)
        A[:n, :n] += np.eye(n) * gmin

        for el in elements:
            i, j = idx(el.n1), idx(el.n2)
            if el.kind == "R":
                if el.dc_value is None or el.dc_value == 0:
                    raise SimulationError(f"resistor {el.name} needs a nonzero value")
                g = 1.0 / el.dc_value
                _stamp_conductance(A, i, j, g)
            elif el.kind == "C":
                continue  # open at DC
            elif el.kind == "I":
                cur = el.dc_value if el.dc_value is not None else 0.0
                if i >= 0:
                    b[i] -= cur
                if j >= 0:
                    b[j] += cur
            elif el.kind == "G":  # VCCS: i(n1→n2) = gm (v(c1) − v(c2))
                _stamp_vccs(A, i, j, idx(el.ctrl_n1), idx(el.ctrl_n2), el.gain or 0.0)
            elif el.kind == "F":  # CCCS: i(n1→n2) = gain · i(Vctrl)
                col = ctrl_branch_col(el)
                if i >= 0:
                    A[i, col] += el.gain or 0.0
                if j >= 0:
                    A[j, col] -= el.gain or 0.0
            elif el.kind == "D":
                vd = vd_state[next(diode_i)]
                e = math.exp(vd / _DIODE_VT)
                gd = (_DIODE_IS / _DIODE_VT) * e + gmin
                id_lin = _DIODE_IS * (e - 1.0) - gd * vd
                _stamp_conductance(A, i, j, gd)
                if i >= 0:
                    b[i] -= id_lin
                if j >= 0:
                    b[j] += id_lin

        for k, el in enumerate(branches):
            i, j = idx(el.n1), idx(el.n2)
            row = n + k
            if i >= 0:
                A[i, row] += 1.0
                A[row, i] += 1.0
            if j >= 0:
                A[j, row] -= 1.0
                A[row, j] -= 1.0
            if el.kind == "V":
                b[row] = el.dc_value if el.dc_value is not None else 0.0
            elif el.kind == "E":  # VCVS: v(n1)−v(n2) = gain (v(c1)−v(c2))
                ci, cj = idx(el.ctrl_n1), idx(el.ctrl_n2)
                if ci >= 0:
                    A[row, ci] -= el.gain or 0.0
                if cj >= 0:
                    A[row, cj] += el.gain or 0.0
            elif el.kind == "H":  # CCVS: v(n1)−v(n2) = rm · i(Vctrl)
                A[row, ctrl_branch_col(el)] -= el.gain or 0.0
            else:  # L: short (0 V)
                b[row] = 0.0

        try:
            x_new = np.linalg.solve(A, b)
        except np.linalg.LinAlgError as e:
            raise SimulationError(f"singular MNA matrix: {e}") from e

        if not diodes:
            x = x_new
            break
        delta = np.max(np.abs(x_new - x)) if size else 0.0
        ref = np.max(np.abs(x_new)) if size else 0.0
        x = x_new
        # Advance each diode's linearization point under pnjlim; the
        # iterate has converged only when the solution AND every
        # junction voltage have settled (a still-limited step means the
        # next stamp changes the system).
        vd_delta = 0.0
        for di, el in enumerate(diodes):
            i, j = idx(el.n1), idx(el.n2)
            vd_new = (x[i] if i >= 0 else 0.0) - (x[j] if j >= 0 else 0.0)
            vd_lim = _pnjlim(vd_new, vd_state[di])
            vd_delta = max(vd_delta, abs(vd_lim - vd_state[di]))
            vd_state[di] = vd_lim
        if delta <= abstol + reltol * ref and vd_delta <= abstol + reltol * ref:
            converged = True
            break

    if not converged:
        raise SimulationError(
            f"DC operating point did not converge after {max_iters} "
            "Newton iterations"
        )

    node_voltages = {name: float(x[i]) for name, i in nodes.items()}
    branch_currents = {
        el.name.lower(): float(x[n + k]) for k, el in enumerate(branches)
    }
    return OperatingPoint(node_voltages, branch_currents)


def solve_ac(netlist_text: str, frequency_hz: float) -> ACSolution:
    """Single-point AC analysis (.ac lin 1 f f)."""
    if frequency_hz <= 0:
        raise SimulationError("AC frequency must be positive")
    elements = parse_netlist(netlist_text)
    if not elements:
        raise SimulationError("empty netlist")
    for el in elements:
        if el.kind not in ("R", "C", "L", "V", "I", "D", "E", "G", "F", "H"):
            raise SimulationError(
                f"unsupported element '{el.name}' of type {el.kind}"
            )

    omega = 2.0 * math.pi * frequency_hz
    nodes = _node_index(elements)
    branches = _branch_elements(elements, dc=False)
    n, m = len(nodes), len(branches)
    size = n + m
    branch_col = {el.name.lower(): n + k for k, el in enumerate(branches)}
    A = np.zeros((size, size), complex)
    b = np.zeros(size, complex)
    A[:n, :n] += np.eye(n) * _GMIN_DEFAULT

    def idx(node: str) -> int:
        return nodes.get(str(node), -1)

    for el in elements:
        i, j = idx(el.n1), idx(el.n2)
        if el.kind == "R":
            if el.dc_value is None or el.dc_value == 0:
                raise SimulationError(
                    f"resistor {el.name} needs a nonzero value"
                )
            _stamp_conductance(A, i, j, 1.0 / el.dc_value)
        elif el.kind == "C":
            if el.reactance is not None:  # -jX given directly
                z = el.reactance
                if z == 0:
                    raise SimulationError(
                        f"capacitor {el.name} needs a nonzero reactance"
                    )
                _stamp_conductance(A, i, j, 1.0 / z)
            else:
                _stamp_conductance(A, i, j, 1j * omega * (el.dc_value or 0.0))
        elif el.kind == "L":
            if el.reactance is not None:
                if el.reactance == 0:
                    raise SimulationError(
                        f"inductor {el.name} needs a nonzero reactance"
                    )
                _stamp_conductance(A, i, j, 1.0 / el.reactance)
            else:
                val = el.dc_value or 0.0
                if val == 0:
                    raise SimulationError(f"inductor {el.name} needs a value")
                _stamp_conductance(A, i, j, 1.0 / (1j * omega * val))
        elif el.kind == "I":
            cur = el.ac_phasor if el.ac_mag is not None else complex(el.dc_value or 0.0)
            if i >= 0:
                b[i] -= cur
            if j >= 0:
                b[j] += cur
        elif el.kind == "G":
            _stamp_vccs(A, i, j, idx(el.ctrl_n1), idx(el.ctrl_n2), el.gain or 0.0)
        elif el.kind == "F":
            col = branch_col.get(el.ctrl_branch or "")
            if col is None:
                raise SimulationError(
                    f"{el.name}: controlling source '{el.ctrl_branch}' not found"
                )
            if i >= 0:
                A[i, col] += el.gain or 0.0
            if j >= 0:
                A[j, col] -= el.gain or 0.0
        elif el.kind == "D":
            # Small-signal: treat as large resistance (no DC bias info).
            _stamp_conductance(A, i, j, _GMIN_DEFAULT)

    for k, el in enumerate(branches):
        i, j = idx(el.n1), idx(el.n2)
        row = n + k
        if i >= 0:
            A[i, row] += 1.0
            A[row, i] += 1.0
        if j >= 0:
            A[j, row] -= 1.0
            A[row, j] -= 1.0
        if el.kind == "V":
            b[row] = el.ac_phasor if el.ac_mag is not None else complex(el.dc_value or 0.0)
        elif el.kind == "E":
            ci, cj = idx(el.ctrl_n1), idx(el.ctrl_n2)
            if ci >= 0:
                A[row, ci] -= el.gain or 0.0
            if cj >= 0:
                A[row, cj] += el.gain or 0.0
        elif el.kind == "H":
            col = branch_col.get(el.ctrl_branch or "")
            if col is None:
                raise SimulationError(
                    f"{el.name}: controlling source '{el.ctrl_branch}' not found"
                )
            A[row, col] -= el.gain or 0.0

    try:
        x = np.linalg.solve(A, b)
    except np.linalg.LinAlgError as e:
        raise SimulationError(f"singular MNA matrix: {e}") from e

    node_voltages = {name: complex(x[i]) for name, i in nodes.items()}
    branch_currents = {el.name.lower(): complex(x[n + k]) for k, el in enumerate(branches)}
    return ACSolution(node_voltages, branch_currents, frequency_hz)


def _stamp_vccs(A: np.ndarray, i: int, j: int, ci: int, cj: int, gm) -> None:
    """i(n_i→n_j) = gm · (v(ci) − v(cj))."""
    if i >= 0 and ci >= 0:
        A[i, ci] += gm
    if i >= 0 and cj >= 0:
        A[i, cj] -= gm
    if j >= 0 and ci >= 0:
        A[j, ci] -= gm
    if j >= 0 and cj >= 0:
        A[j, cj] += gm


def _stamp_conductance(A: np.ndarray, i: int, j: int, g) -> None:
    if i >= 0:
        A[i, i] += g
    if j >= 0:
        A[j, j] += g
    if i >= 0 and j >= 0:
        A[i, j] -= g
        A[j, i] -= g
