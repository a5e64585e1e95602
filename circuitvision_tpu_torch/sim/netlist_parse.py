"""SPICE netlist text → element records for the MNA solver.

The JAX package's `sim/netlist_parse.py`, copied.
Parses the subset of SPICE the pipeline emits (stringify output,
src/circuit_analyzer.py:1909-1927, plus the AC rewrites of
src/spice_simulator.py:126-181): R, C, L, V, I, D elements with plain,
metric-suffixed, reactance (j…), or "dc AC mag phase" values.
"""
from __future__ import annotations

import cmath
import dataclasses
import math
import re
from typing import Optional

from ..netlist.values import parse_component_value

_AC_SPEC = re.compile(
    r"^([-+]?[\d.eE+-]+)?\s*AC\s+([-+]?[\d.eE+-]+)(?:\s+([-+]?[\d.eE+-]+))?$",
    re.IGNORECASE,
)

_SPICE_NUM = re.compile(
    r"^([-+]?\d*\.?\d+(?:[eE][-+]?\d+)?)([a-zA-ZµμΩΩ]*)$"
)
#: ngspice scale factors, longest first; letters after the factor are
#: ignored (so "10kohm" is 10e3 and "47farad" is 47 femto — the engine
#: the reference simulates through reads it exactly that way).
_SPICE_SCALE = (
    ("meg", 1e6), ("mil", 25.4e-6), ("t", 1e12), ("g", 1e9), ("k", 1e3),
    ("m", 1e-3), ("µ", 1e-6), ("μ", 1e-6), ("u", 1e-6), ("n", 1e-9),
    ("p", 1e-12), ("f", 1e-15), ("a", 1e-18),
)


def parse_spice_value(token: str):
    """Deck-token value with ngspice semantics (case-INSENSITIVE scale
    factors: '10M' is 10 milli, '10MEG' is 10 mega, '47f' is 47 femto —
    unlike the VLM-string parser in netlist/values.py, whose domain is
    the reference's engineering-notation strings where M means mega).
    j-reactance forms ("j5", "5j", "100-j50" — the reference's AC
    rewrites, src/spice_simulator.py:126-181) and the VLM parser's
    "5x10^-5" form fall through to parse_component_value."""
    t = str(token).strip()
    if "j" in t.lower():
        return parse_component_value(token)
    m = _SPICE_NUM.match(t)
    if not m:
        return parse_component_value(token)
    num = float(m.group(1))
    tail = m.group(2).lower()
    for suffix, mult in _SPICE_SCALE:
        if tail.startswith(suffix):
            return num * mult
    return num


@dataclasses.dataclass
class Element:
    kind: str  # R, C, L, V, I, D, E, G, F, H
    name: str  # e.g. V1
    n1: str
    n2: str
    dc_value: Optional[float] = None
    ac_mag: Optional[float] = None
    ac_phase_deg: Optional[float] = None
    reactance: Optional[complex] = None  # for j-valued C/L impedances
    raw_value: str = ""
    # Dependent sources: controlling nodes (E/G) or controlling V-source
    # branch name (F/H), plus gain.
    ctrl_n1: Optional[str] = None
    ctrl_n2: Optional[str] = None
    ctrl_branch: Optional[str] = None
    gain: Optional[float] = None

    @property
    def ac_phasor(self) -> complex:
        mag = self.ac_mag if self.ac_mag is not None else 0.0
        ph = math.radians(self.ac_phase_deg or 0.0)
        return cmath.rect(mag, ph)


class NetlistParseError(ValueError):
    pass


def parse_netlist(text: str) -> list[Element]:
    """Parse netlist body text (no .title/.end needed; comments skipped)."""
    elements: list[Element] = []
    for lineno, line in enumerate(text.split("\n"), start=1):
        stripped = line.strip()
        if not stripped or stripped.startswith("*") or stripped.startswith("."):
            continue
        parts = stripped.split()
        if len(parts) < 3:
            raise NetlistParseError(f"line {lineno}: too few fields: {stripped!r}")
        name, n1, n2 = parts[0], parts[1], parts[2]
        kind = name[0].upper()
        value_str = " ".join(parts[3:]) if len(parts) > 3 else ""
        el = Element(kind=kind, name=name, n1=n1, n2=n2, raw_value=value_str)

        # Dependent sources use standard SPICE syntax:
        #   Exxx n+ n- nc+ nc- gain      (VCVS)   Gxxx n+ n- nc+ nc- gm (VCCS)
        #   Fxxx n+ n- Vname gain        (CCCS)   Hxxx n+ n- Vname rm   (CCVS)
        if kind in ("E", "G"):
            if len(parts) < 6:
                raise NetlistParseError(
                    f"line {lineno}: {kind}-source {name} needs 'n+ n- nc+ nc- gain'"
                )
            el.ctrl_n1, el.ctrl_n2 = parts[3], parts[4]
            try:
                el.gain = float(parse_spice_value(parts[5]))
            except (ValueError, TypeError) as e:
                raise NetlistParseError(f"line {lineno}: bad gain for {name}: {e}")
            elements.append(el)
            continue
        if kind in ("F", "H"):
            if len(parts) < 5:
                raise NetlistParseError(
                    f"line {lineno}: {kind}-source {name} needs 'n+ n- Vname gain'"
                )
            el.ctrl_branch = parts[3].lower()
            try:
                el.gain = float(parse_spice_value(parts[4]))
            except (ValueError, TypeError) as e:
                raise NetlistParseError(f"line {lineno}: bad gain for {name}: {e}")
            elements.append(el)
            continue

        if value_str:
            m = _AC_SPEC.match(value_str)
            if m and kind in ("V", "I"):
                el.dc_value = float(m.group(1)) if m.group(1) else 0.0
                el.ac_mag = float(m.group(2))
                el.ac_phase_deg = float(m.group(3)) if m.group(3) else 0.0
            else:
                token = parts[3]
                if token.lower() == "none":
                    raise NetlistParseError(
                        f"line {lineno}: element {name} has no numeric value "
                        f"(value 'None'); fill values before simulating"
                    )
                try:
                    v = parse_spice_value(token)
                except ValueError as e:
                    raise NetlistParseError(f"line {lineno}: {e}") from e
                if isinstance(v, complex):
                    el.reactance = v
                else:
                    el.dc_value = float(v)
        elements.append(el)
    return elements
