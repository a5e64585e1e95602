"""ctypes bridge to the native C++ MNA solver (sim/native/solver.cpp).

The JAX package's `sim/native_backend.py`, with the port's build: the
source is compiled with g++ by `core/native.build_library` into the
package's git-ignored build/ directory at first use (no library is
committed), and a build or load that fails raises — the engine has no
numpy fallback that would hide it (sim/engine.py). Results are
bit-compatible with mna.py on the elements the solver takes; a netlist
with dependent sources (E/G/F/H) goes to mna.py, as in the JAX package.
"""
from __future__ import annotations

import ctypes
import functools
import math
import subprocess
from pathlib import Path

import numpy as np

from ..core.native import build_library
from .mna import ACSolution, OperatingPoint, SimulationError, _node_index
from .netlist_parse import parse_netlist

_SRC = Path(__file__).resolve().parent / "native" / "solver.cpp"


def native_available() -> bool:
    """Whether the native solver can be used (JAX sim/native_backend.py:23):
    here, whether it builds and loads (g++ at first use)."""
    try:
        load_library()
    except (OSError, subprocess.CalledProcessError):
        return False
    return True


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the solver; raises on failure."""
    lib = build_library(_SRC, "cvsolver")
    lib.cv_solve_dc.restype = ctypes.c_int
    lib.cv_solve_dc.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.cv_solve_ac.restype = ctypes.c_int
    lib.cv_solve_ac.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int),
    ]
    return lib


def _prep(elements, nodes):
    kinds = "".join(el.kind for el in elements).encode()
    n1 = np.asarray([nodes.get(str(el.n1), -1) for el in elements], np.int32)
    n2 = np.asarray([nodes.get(str(el.n2), -1) for el in elements], np.int32)
    return kinds, n1, n2


def solve_dc_native(
    netlist_text: str,
    gmin: float = 1e-12,
    abstol: float = 1e-12,
    reltol: float = 1e-6,
    max_iters: int = 100,
) -> OperatingPoint:
    lib = load_library()
    elements = parse_netlist(netlist_text)
    if not elements:
        raise SimulationError("empty netlist")
    if any(el.kind in ("E", "G", "F", "H") for el in elements):
        # Dependent sources: delegate to the numpy solver (the native
        # kernel covers the hot pipeline subset R/C/L/V/I/D).
        from . import mna

        return mna.solve_dc(
            netlist_text, gmin=gmin, abstol=abstol, reltol=reltol, max_iters=max_iters
        )
    for el in elements:
        if el.kind not in ("R", "C", "L", "V", "I", "D"):
            raise SimulationError(f"unsupported element '{el.name}' of type {el.kind}")
        if el.kind == "R" and not el.dc_value:
            raise SimulationError(f"resistor {el.name} needs a nonzero value")
    nodes = _node_index(elements)
    kinds, n1, n2 = _prep(elements, nodes)
    value = np.asarray(
        [el.dc_value if el.dc_value is not None else 0.0 for el in elements], np.float64
    )
    n = len(nodes)
    branches = [el for el in elements if el.kind in ("V", "L")]
    out = np.zeros(n + len(branches), np.float64)
    nb = ctypes.c_int(0)
    rc = lib.cv_solve_dc(
        len(elements),
        kinds,
        n1.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n2.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        value.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        gmin,
        abstol,
        reltol,
        max_iters,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(nb),
    )
    if rc == 2:
        raise SimulationError(
            f"DC operating point did not converge after {max_iters} "
            "Newton iterations"
        )
    if rc != 0:
        raise SimulationError(f"native DC solve failed (code {rc}; singular matrix?)")
    node_voltages = {name: float(out[i]) for name, i in nodes.items()}
    branch_currents = {
        el.name.lower(): float(out[n + k]) for k, el in enumerate(branches)
    }
    return OperatingPoint(node_voltages, branch_currents)


def solve_ac_native(netlist_text: str, frequency_hz: float) -> ACSolution:
    lib = load_library()
    if frequency_hz <= 0:
        raise SimulationError("AC frequency must be positive")
    elements = parse_netlist(netlist_text)
    if not elements:
        raise SimulationError("empty netlist")
    if any(el.kind in ("E", "G", "F", "H") for el in elements):
        from . import mna

        return mna.solve_ac(netlist_text, frequency_hz)
    for el in elements:
        if el.kind not in ("R", "C", "L", "V", "I", "D"):
            raise SimulationError(f"unsupported element '{el.name}' of type {el.kind}")
    nodes = _node_index(elements)
    kinds, n1, n2 = _prep(elements, nodes)
    v_re = np.zeros(len(elements), np.float64)
    v_im = np.zeros(len(elements), np.float64)
    flags = np.zeros(len(elements), np.int32)
    for i, el in enumerate(elements):
        if el.kind in ("V", "I"):
            ph = el.ac_phasor if el.ac_mag is not None else complex(el.dc_value or 0.0)
            v_re[i], v_im[i] = ph.real, ph.imag
        elif el.reactance is not None:
            v_re[i], v_im[i] = el.reactance.real, el.reactance.imag
            flags[i] = 1
        else:
            if el.kind == "L" and not el.dc_value:
                raise SimulationError(f"inductor {el.name} needs a value")
            v_re[i] = el.dc_value or 0.0
    n = len(nodes)
    branches = [el for el in elements if el.kind == "V"]
    out = np.zeros(2 * (n + len(branches)), np.float64)
    nb = ctypes.c_int(0)
    rc = lib.cv_solve_ac(
        len(elements),
        kinds,
        n1.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n2.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        v_re.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        v_im.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        flags.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n,
        2.0 * math.pi * frequency_hz,
        1e-12,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(nb),
    )
    if rc != 0:
        raise SimulationError(f"native AC solve failed (code {rc}; singular matrix?)")
    cx = out[0::2] + 1j * out[1::2]
    node_voltages = {name: complex(cx[i]) for name, i in nodes.items()}
    branch_currents = {
        el.name.lower(): complex(cx[n + k]) for k, el in enumerate(branches)
    }
    return ACSolution(node_voltages, branch_currents, frequency_hz)
