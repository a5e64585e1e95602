"""Component value parsing and AC source string handling.

The JAX package's `netlist/values.py`, copied (it imports no JAX). It
re-implements the value-handling capability surface of the reference:
  - parse_component_value   (src/utils.py:432-549)
  - _parse_vlm_ac_string    (src/utils.py:637-694)
  - AC/DC mode auto-detect  (app.py:839-874)
  - DC netlist pre-processing (reactance commenting, src/spice_simulator.py:16-46)
  - AC source/C/L value rewriting (src/spice_simulator.py:126-181)

Note: the reference's `parse_component_value` checks metric prefixes with
`startswith` after lower-casing, so ordinary suffix forms like "10k" raise
(it is dead code in the reference pipeline). This implementation parses the
conventional suffix forms correctly while covering every format the
reference's docstring promises.
"""
from __future__ import annotations

import math
import re
from typing import Optional, Union

# Case-sensitive metric suffixes. 'M' (mega) vs 'm' (milli) must differ.
_METRIC_SUFFIXES = {
    "Y": 1e24,
    "Z": 1e21,
    "E": 1e18,
    "P": 1e15,
    "T": 1e12,
    "G": 1e9,
    "M": 1e6,
    "k": 1e3,
    "K": 1e3,
    "m": 1e-3,
    "u": 1e-6,
    "µ": 1e-6,  # µ
    "μ": 1e-6,  # μ
    "n": 1e-9,
    "p": 1e-12,
    "f": 1e-15,
    "a": 1e-18,
    "z": 1e-21,
    "y": 1e-24,
}

# Units stripped from the tail (after any metric prefix), longest first.
_UNIT_PATTERN = re.compile(
    r"(ohms?|ohm|farads?|henr(?:y|ies)|volts?|amps?|amperes?|hz|[ΩΩVvAaFfHh])\s*$"
)

_SCI_PATTERNS = [
    re.compile(r"^([-+]?\d+\.?\d*)\s*[x*]\s*10\^?\s*([-+]?\d+)$"),
    re.compile(r"^([-+]?\d+\.?\d*)[eE]([-+]?\d+)$"),
]

_COMPLEX_PATTERNS = [
    re.compile(r"^([-+]?\d*\.?\d+)\s*([+-])\s*j(\d*\.?\d*)$"),  # 5+j3 / 5-j3
    re.compile(r"^([-+]?\d*\.?\d+)\s*([+-])\s*(\d*\.?\d*)j$"),  # 5+3j / 5-3j
    re.compile(r"^([-+]?)j(\d*\.?\d*)$"),  # j5 / -j3
]


def parse_component_value(value: Union[str, float, int]) -> Union[float, complex]:
    """Parse a component value string to a float (or complex for impedances).

    Handles: plain numbers, metric suffixes ("10k", "2.2M", "100m", "0.5u",
    "22n", "47p"), scientific notation ("5e-5", "5x10^-5", "5 * 10^-5"),
    complex impedances ("5+j3", "100-j50", "j5"), and trailing units
    ("10kΩ", "5V", "2.2uF").
    """
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    raw = str(value).strip()
    if not raw:
        raise ValueError(f"Could not parse value: {value!r}")
    s = raw.replace(" ", "")

    # Complex impedances first (case-insensitive on 'j').
    low = s.lower()
    for pat in _COMPLEX_PATTERNS[:2]:
        m = pat.match(low)
        if m:
            real = float(m.group(1))
            imag = float(m.group(3)) if m.group(3) else 1.0
            if m.group(2) == "-":
                imag = -imag
            return complex(real, imag)
    m = _COMPLEX_PATTERNS[2].match(low)
    if m:
        imag = float(m.group(2)) if m.group(2) else 1.0
        return complex(0.0, -imag if m.group(1) == "-" else imag)

    # Scientific notation.
    for pat in _SCI_PATTERNS:
        m = pat.match(s)
        if m:
            return float(m.group(1)) * (10.0 ** int(m.group(2)))

    # Strip a trailing unit (before looking at the metric suffix the unit may
    # shadow, e.g. "10kΩ" → "10k").  "meg" SPICE-style prefix special-cased.
    body = _UNIT_PATTERN.sub("", s)
    if not body:
        body = s  # the whole token was unit-like; let float() decide below

    try:
        return float(body)
    except ValueError:
        pass

    mlow = body.lower()
    if mlow.endswith("meg"):
        try:
            return float(body[:-3]) * 1e6
        except ValueError:
            pass

    suffix = body[-1]
    if suffix in _METRIC_SUFFIXES:
        try:
            return float(body[:-1]) * _METRIC_SUFFIXES[suffix]
        except ValueError:
            pass

    raise ValueError(f"Could not parse value: {value!r}")


# ---------------------------------------------------------------------------
# AC source string parsing (src/utils.py:637-694)
# ---------------------------------------------------------------------------

_AC_LONG = re.compile(
    r"AC\s*"
    r"([+-]?\d*\.?\d+)\s*[a-zA-ZμmkKVAMWΩ°]*\s*"
    r"(?:[+-]?\d*\.?\d+)\s*[a-zA-ZμmkKVAMWΩHz°]*\s*"
    r"([+-]?\d*\.?\d+)\s*[a-zA-ZμmkKVAMWΩ°deg]*",
    re.IGNORECASE,
)
_AC_SHORT = re.compile(
    r"AC\s*"
    r"([+-]?\d*\.?\d+)\s*[a-zA-ZμmkKVAMWΩ°]*\s*"
    r"([+-]?\d*\.?\d+)\s*[a-zA-ZμmkKVAMWΩ°deg]*",
    re.IGNORECASE,
)
_AC_MAG_PHASE = re.compile(r"\s*([+-]?\d*\.?\d+)\s*:\s*([+-]?\d*\.?\d+)\s*")


def parse_ac_string(raw: object) -> Optional[dict]:
    """Parse VLM-emitted AC source strings.

    Accepts "AC 5V 1kHz 0deg", "AC 5V 0deg", and phasor "4:-45" forms;
    returns {'dc_offset': 0, 'mag': float, 'phase': float} or None.
    (reference _parse_vlm_ac_string, src/utils.py:637-694)
    """
    if not isinstance(raw, str):
        return None
    text = raw.strip()

    m = _AC_LONG.match(text)
    if m:
        try:
            return {"dc_offset": 0, "mag": float(m.group(1)), "phase": float(m.group(2))}
        except (IndexError, ValueError):
            pass
    m = _AC_SHORT.match(text)
    if m:
        try:
            return {"dc_offset": 0, "mag": float(m.group(1)), "phase": float(m.group(2))}
        except (IndexError, ValueError):
            pass
    m = _AC_MAG_PHASE.fullmatch(text)
    if m:
        try:
            return {"dc_offset": 0, "mag": float(m.group(1)), "phase": float(m.group(2))}
        except (IndexError, ValueError):
            pass
    return None


# ---------------------------------------------------------------------------
# AC/DC analysis mode auto-detection (app.py:839-874)
# ---------------------------------------------------------------------------

_MAG_PHASE_FULL = re.compile(r"^[+-]?\d*\.?\d+\s*:\s*[+-]?\d*\.?\d+$")


def detect_analysis_mode(netlist_text: str) -> str:
    """Return 'AC' if any V/I source line carries AC syntax, else 'DC'."""
    for line in (netlist_text or "").split("\n"):
        stripped = line.strip()
        if not stripped or not stripped[0].isalpha():
            continue
        upper = stripped.upper()
        parts = stripped.split()
        ctype = upper[0]
        if ctype in ("V", "I"):
            if " AC " in upper:
                return "AC"
            if len(parts) >= 4:
                for part in parts[3:]:
                    if _MAG_PHASE_FULL.fullmatch(part.strip()):
                        return "AC"
    return "DC"


# ---------------------------------------------------------------------------
# DC pre-processing: comment out C/L reactance lines (src/spice_simulator.py:16-46)
# ---------------------------------------------------------------------------


def preprocess_netlist_for_dc(netlist_text: str) -> str:
    """Comment out C/L lines whose value is a pure reactance (j.../-j...)."""
    out = []
    for line in netlist_text.split("\n"):
        stripped = line.strip()
        if not stripped:
            out.append(line)
            continue
        parts = stripped.split()
        first = parts[0][0].upper() if parts and parts[0] else ""
        problematic = (
            first in ("C", "L")
            and len(parts) >= 4
            and (parts[3].startswith("j") or parts[3].startswith("-j"))
        )
        if problematic:
            out.append(f"* {line} ; DC analysis: reactance value ignored")
        else:
            out.append(line)
    return "\n".join(out)


# ---------------------------------------------------------------------------
# AC value rewriting (src/spice_simulator.py:126-181)
# ---------------------------------------------------------------------------


def rewrite_value_for_ac(component_type: str, value: object, freq_hz: float) -> object:
    """Rewrite one netlist value for single-frequency AC analysis.

    V/I: parsed AC string → "{dc} AC {mag} {phase}"; unparseable AC-looking
         strings fall back to "0 AC 1 0".
    C:   "-jX" reactance → C = 1/(2πfX).
    L:   "jX" or "Xj" reactance → L = X/(2πf).
    Anything else is returned unchanged.
    """
    sval = str(value if value is not None else "")
    if component_type in ("V", "I"):
        parsed = parse_ac_string(sval)
        if parsed:
            return f"{parsed['dc_offset']} AC {parsed['mag']} {parsed['phase']}"
        if sval.lower().strip().startswith("ac") or ":" in sval:
            return "0 AC 1 0"
        return value
    if component_type == "C":
        low = sval.lower()
        if low.startswith("-j"):
            try:
                xc = float(low[2:]) if low[2:] else 1.0
            except ValueError:
                return value
            if xc > 0 and freq_hz > 0:
                return 1.0 / (2.0 * math.pi * freq_hz * xc)
        return value
    if component_type == "L":
        low = sval.lower()
        xl = None
        if low.startswith("j"):
            try:
                xl = float(low[1:]) if low[1:] else 1.0
            except ValueError:
                xl = None
        elif low.endswith("j") and "j" in low:
            try:
                xl = float(low[:-1]) if low[:-1] else 1.0
            except ValueError:
                xl = None
        if xl is not None and xl > 0 and freq_hz > 0:
            return xl / (2.0 * math.pi * freq_hz)
        return value
    return value
