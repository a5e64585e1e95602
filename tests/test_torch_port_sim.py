"""The port's simulation (`netlist/values.py`, `sim/netlist_parse.py`,
`sim/mna.py`, `sim/native_backend.py`, `sim/engine.py`) and
`CircuitAnalyzerTorch.simulate` against the JAX package, on the CPU.

One parametrised test over the 63 eval_data netlists (DC, or AC on the
text path at 60 Hz, as the CLI's `simulate` picks) and the cases of
tests/test_sim.py and of the value helpers: on both sides the same call,
and the outcome must agree — the same exception type and message, or
byte-equal strings (`ok`, `error`, `deck`, formatted voltages and
currents, parsed elements and values) and raw floats equal: exactly for
the port's numpy solver against JAX's numpy solver, within 1e-12
relative per value for the port's native solver (built here with g++)
against the JAX package's committed `libcvsolver.so`.
"""
import dataclasses
import math
from pathlib import Path
from types import SimpleNamespace

import pytest

from circuitvision_tpu.core import config as jconfig
from circuitvision_tpu.core import types as jtypes
from circuitvision_tpu.netlist import values as jvalues
from circuitvision_tpu.pipeline.analyzer import CircuitAnalyzerTPU
from circuitvision_tpu.sim import engine as jengine
from circuitvision_tpu.sim import mna as jmna
from circuitvision_tpu.sim import native_backend as jnative
from circuitvision_tpu.sim import netlist_parse as jparse
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.core import types as ttypes
from circuitvision_tpu_torch.models.yolo.model import YOLOv11
from circuitvision_tpu_torch.netlist import values as tvalues
from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch
from circuitvision_tpu_torch.sim import engine as tengine
from circuitvision_tpu_torch.sim import mna as tmna
from circuitvision_tpu_torch.sim import native_backend as tnative
from circuitvision_tpu_torch.sim import netlist_parse as tparse

ROOT = Path(__file__).resolve().parents[1]
NETLISTS = sorted((ROOT / "eval_data" / "netlists").glob("*.cir"))
#: port native solver against the JAX package's, per value
NATIVE_RTOL = 1e-12

JAX = SimpleNamespace(values=jvalues, parse=jparse, mna=jmna, engine=jengine,
                      dc_native=jnative.solve_dc_native, ac_native=jnative.solve_ac_native,
                      SimConfig=jconfig.SimConfig, NetlistLine=jtypes.NetlistLine)
PORT = SimpleNamespace(values=tvalues, parse=tparse, mna=tmna, engine=tengine,
                       dc_native=tnative.solve_dc_native, ac_native=tnative.solve_ac_native,
                       SimConfig=tconfig.SimConfig, NetlistLine=ttypes.NetlistLine)


def _netlist_case(path):
    text = path.read_text()
    if jvalues.detect_analysis_mode(text) == "AC":
        return lambda P, native: P.engine.perform_ac_analysis_text(
            text, 60.0, P.SimConfig(prefer_native=native))
    return lambda P, native: P.engine.perform_dc_analysis(text, P.SimConfig(prefer_native=native))


def _dc(text, **kw):
    return lambda P, native: (P.dc_native if native else P.mna.solve_dc)(text, **kw)


def _ac(text, f):
    return lambda P, native: (P.ac_native if native else P.mna.solve_ac)(text, f)


def _lines(P, rows):
    return [P.NetlistLine(t, 1, a, b, v, class_name=c) for t, a, b, v, c in rows]


_RC_F = 1000.0
_RC_C = 1.0 / (2 * math.pi * _RC_F * 1000.0)
_RL_L = 1000.0 / (2 * math.pi * _RC_F)
#: tests/test_sim.py, case by case, as calls on either package
#: (name → (call, takes_backend))
SIM_CASES = {
    # TestParse
    "parse-basic": (lambda P, _: P.parse.parse_netlist("V1 1 0 5\nR1 1 0 10k\nC1 1 0 1u"), False),
    "parse-ac-spec": (lambda P, _: P.parse.parse_netlist("V1 1 0 0 AC 4.0 -45.0"), False),
    "parse-reactance": (lambda P, _: P.parse.parse_netlist("C1 1 0 -j50"), False),
    "parse-comments": (lambda P, _: P.parse.parse_netlist(
        "* comment\n.title x\nR1 1 0 100\n\n.end"), False),
    "parse-scale-factors": (lambda P, _: [P.parse.parse_spice_value(t) for t in (
        "47f", "10M", "10MEG", "10kohm", "47pF", "5a", "2.5", "1e-6", "j5", "100-j50")]
        + [P.parse.parse_netlist("C1 1 0 47f\nR1 1 0 10MEG")], False),
    "parse-none-value": (lambda P, _: P.parse.parse_netlist("R1 1 0 None"), False),
    "parse-short-e-line": (lambda P, _: P.parse.parse_netlist("E1 2 0 5"), False),
    "ac-resistor-no-value": (_ac("R1 1 0\nV1 1 0 AC 1 0", 50.0), True),
    "ac-resistor-zero": (_ac("R1 1 0 0\nV1 1 0 AC 1 0", 50.0), True),
    # TestDC
    "dc-divider": (_dc("V1 1 0 10\nR1 1 2 1k\nR2 2 0 1k"), True),
    "dc-current-source": (_dc("I1 0 1 1m\nR1 1 0 1k"), True),
    "dc-cap-open": (_dc("V1 1 0 10\nR1 1 2 1k\nC1 2 0 1u"), True),
    "dc-inductor-short": (_dc("V1 1 0 10\nR1 1 2 1k\nL1 2 0 1m"), True),
    "dc-diode-forward": (_dc("V1 1 0 5\nR1 1 2 1k\nD1 2 0"), True),
    "dc-diode-reverse": (_dc("V1 1 0 -5\nR1 1 2 1k\nD1 2 0"), True),
    "dc-unsupported": (_dc("Q1 1 0 2"), True),
    "dc-diode-high-current": (_dc("I1 0 1 100\nD1 1 0"), True),
    "dc-nonconvergence": (_dc("I1 0 1 100\nD1 1 0", max_iters=3), True),
    # TestAC
    "ac-rc-divider": (_ac(f"V1 1 0 0 AC 1 0\nR1 1 2 1k\nC1 2 0 {_RC_C}", _RC_F), True),
    "ac-reactance-form": (_ac("V1 1 0 0 AC 1 0\nR1 1 2 1000\nC1 2 0 -j1000", 60.0), True),
    "ac-rl-highpass": (_ac(f"V1 1 0 0 AC 1 0\nR1 1 2 1k\nL1 2 0 {_RL_L}", _RC_F), True),
    "ac-source-phase": (_ac("V1 1 0 0 AC 4 -45\nR1 1 0 100", 60.0), True),
    "ac-zero-frequency": (_ac("V1 1 0 0 AC 1 0\nR1 1 0 1k", 0.0), True),
    # TestEngine
    "engine-dc-formatting": (lambda P, n: P.engine.perform_dc_analysis(
        "V1 1 0 10\nR1 1 2 1k\nR2 2 0 1k", P.SimConfig(prefer_native=n)), True),
    "engine-dc-reactive-ignored": (lambda P, n: P.engine.perform_dc_analysis(
        "V1 1 0 10\nR1 1 0 1k\nC1 1 0 -j50", P.SimConfig(prefer_native=n)), True),
    "engine-dc-empty": (lambda P, n: P.engine.perform_dc_analysis(
        "", P.SimConfig(prefer_native=n)), True),
    "engine-dc-error": (lambda P, n: P.engine.perform_dc_analysis(
        "R1 1 0 None", P.SimConfig(prefer_native=n)), True),
    "engine-ac-structured": (lambda P, n: P.engine.perform_ac_analysis(_lines(P, [
        ("V", 1, 0, "4:-45", "voltage.ac"), ("R", 1, 0, "100", "resistor"),
        ("0", 1, 0, None, "gnd")]), 60.0, P.SimConfig(prefer_native=n)), True),
    "engine-ac-cap-rewrite": (lambda P, n: P.engine.perform_ac_analysis(_lines(P, [
        ("V", 1, 0, "AC 10V 60Hz 0deg", "voltage.ac"), ("R", 1, 2, "1k", "resistor"),
        ("C", 2, 0, "-j1000", "capacitor")]), 60.0, P.SimConfig(prefer_native=n)), True),
    "engine-ac-text-phasor": (lambda P, n: P.engine.perform_ac_analysis_text(
        "V1 1 0 4:-45\nR1 1 0 100", 60.0, P.SimConfig(prefer_native=n)), True),
    # TestDependentSources
    "dep-vcvs": (_dc("V1 1 0 1\nR1 1 0 1k\nE1 2 0 1 0 5\nR2 2 0 1k"), True),
    "dep-vccs": (_dc("V1 1 0 1\nR1 1 0 1k\nG1 0 2 1 0 1m\nR2 2 0 1k"), True),
    "dep-cccs": (_dc("V1 1 0 1\nR1 1 0 1k\nF1 0 2 V1 2\nR2 2 0 1k"), True),
    "dep-ccvs": (_dc("V1 1 0 1\nR1 1 0 1k\nH1 2 0 V1 2k\nR2 2 0 1k"), True),
    "dep-vcvs-ac": (_ac("V1 1 0 0 AC 1 0\nR1 1 0 1k\nE1 2 0 1 0 5\nR2 2 0 1k", 60.0), True),
    "dep-missing-control": (_dc("V1 1 0 1\nR1 1 0 1k\nF1 0 2 V9 2\nR2 2 0 1k"), True),
    # netlist/values.py
    "values-parse-component": (lambda P, _: [_call(P.values.parse_component_value, t) for t in (
        "10k", "2.2M", "100m", "0.5u", "22n", "47p", "5e-5", "5x10^-5", "5 * 10^-5", "5+j3",
        "100-j50", "j5", "-j3", "10kΩ", "5V", "2.2uF", "1meg", 47, 2.5, "abc", "")], False),
    "values-parse-ac-string": (lambda P, _: [P.values.parse_ac_string(t) for t in (
        "AC 5V 1kHz 0deg", "AC 5V 0deg", "4:-45", " 2.5 : 30 ", "junk", 5, None)], False),
    "values-detect-mode": (lambda P, _: [P.values.detect_analysis_mode(t) for t in (
        "V1 1 0 5\nR1 1 0 1k", "V1 1 0 AC 5 0", "V1 1 0 4:-45\nR1 1 0 1", "I1 0 1 1:30",
        "R1 1 0 4:-45", "", None)], False),
    "values-preprocess-dc": (lambda P, _: P.values.preprocess_netlist_for_dc(
        "V1 1 0 10\nC1 1 0 -j50\nL1 1 2 j20\nC2 2 0 1u\n\nR1 2 0 1k"), False),
    "values-rewrite-ac": (lambda P, _: [P.values.rewrite_value_for_ac(k, v, f) for k, v, f in (
        ("V", "4:-45", 60.0), ("V", "AC 10V 60Hz 0deg", 60.0), ("I", "AC junk", 60.0),
        ("V", "5", 60.0), ("C", "-j1000", 60.0), ("C", "-j", 50.0), ("C", "-jx", 60.0),
        ("C", "1u", 60.0), ("L", "j20", 60.0), ("L", "20j", 60.0), ("L", "jy", 60.0),
        ("L", "j20", 0.0), ("R", "1k", 60.0), ("V", None, 60.0))], False),
}


def _call(fn, *args):
    try:
        return fn(*args)
    except Exception as exc:
        return ("raises", type(exc).__name__, str(exc))


CASES = [pytest.param(_netlist_case(p), native, id=f"{p.stem}-{'native' if native else 'numpy'}")
         for p in NETLISTS for native in (False, True)]
CASES += [pytest.param(call, native, id=f"{name}-{'native' if native else 'numpy'}")
          for name, (call, backend) in SIM_CASES.items() for native in (False, True)
          if backend or not native]


def _split(out):
    """(exactly compared part, {name: float or complex} compared with the
    backend's tolerance) of an outcome."""
    if isinstance(out, (jengine.DCResult, jengine.ACResult, tengine.DCResult,
                        tengine.ACResult)):
        raw, floats = _split(out.raw) if out.raw is not None else (None, {})
        return (type(out).__name__, out.ok, out.error, out.deck, out.node_voltages,
                out.branch_currents, raw), floats
    if isinstance(out, (jmna.OperatingPoint, jmna.ACSolution, tmna.OperatingPoint,
                        tmna.ACSolution)):
        floats = {f"v:{k}": v for k, v in out.node_voltages.items()}
        floats.update({f"i:{k}": i for k, i in out.branch_currents.items()})
        return (type(out).__name__, list(floats), getattr(out, "frequency_hz", None)), floats
    if isinstance(out, list):
        return [dataclasses.asdict(e) if dataclasses.is_dataclass(e) else _split(e)[0]
                for e in out], {}
    return out, {}


def _outcome(call, P, native):
    try:
        return _split(call(P, native))
    except Exception as exc:
        return ("raises", type(exc).__name__, str(exc)), {}


@pytest.fixture(scope="module", autouse=True)
def _native_solvers():
    """The JAX package's committed solver must load (else its engine would
    compare numpy against the port's native solver), and the port's
    builds here."""
    assert jnative.native_available()
    tnative.load_library()


@pytest.mark.parametrize("call,native", CASES)
def test_sim_matches_jax(call, native):
    (want, want_f), (got, got_f) = _outcome(call, JAX, native), _outcome(call, PORT, native)
    assert got == want
    assert got_f.keys() == want_f.keys()
    for k, w in want_f.items():
        g = got_f[k]
        if native:
            assert abs(g - w) <= NATIVE_RTOL * abs(w), (k, g, w)
        else:
            assert g == w, (k, g, w)


def test_eval_netlists_outcomes():
    """What the 63 eval netlists give on the text path, in the port as in
    the JAX package: 32 DC netlists solve, 18 fail, and all 13 AC
    netlists fail (their '4:-45' sources, or a value left 'None'); the
    structured path, which rewrites '4:-45', is
    test_analyzer_simulate_matches_jax's."""
    counts = {}
    for p in NETLISTS:
        r = _netlist_case(p)(PORT, False)
        mode = "AC" if isinstance(r, tengine.ACResult) else "DC"
        counts[(mode, r.ok)] = counts.get((mode, r.ok), 0) + 1
        if mode == "AC":
            assert "Could not parse value" in r.error or "has no numeric value" in r.error
    assert counts == {("DC", True): 32, ("DC", False): 18, ("AC", False): 13}


def _result(P, rows, text):
    cls = jtypes.AnalysisResult if P is JAX else ttypes.AnalysisResult
    return cls(original_image=None, netlist=_lines(P, rows), netlist_text=text)


SIM_RESULTS = {
    "ac-phasor": ([("V", 1, 0, "4:-45", "voltage.ac"), ("R", 1, 2, "1k", "resistor"),
                   ("C", 2, 0, "-j1000", "capacitor"), ("0", 1, 0, None, "gnd")],
                  "V1 1 0 4:-45\nR1 1 2 1k\nC1 2 0 -j1000"),
    "ac-long-form": ([("V", 1, 0, "AC 10V 60Hz 0deg", "voltage.ac"),
                      ("L", 1, 2, "j50", "inductor"), ("R", 1, 2, "100", "resistor"),
                      ("R", 2, 0, "100", "resistor")],
                     "V1 1 0 AC 10V 60Hz 0deg\nL1 1 2 j50\nR1 1 2 100\nR2 2 0 100"),
    "dc": ([("V", 1, 0, "10", "voltage.dc"), ("R", 1, 2, "1k", "resistor"),
            ("R", 2, 0, "1k", "resistor")], "V1 1 0 10\nR1 1 2 1k\nR2 2 0 1k"),
}


@pytest.fixture(scope="module")
def analyzers():
    """A stand-in for the JAX analyzer (its `simulate` reads only cfg.sim)
    and the port's analyzer at a tiny YOLO on the CPU."""
    cfg = tconfig.PipelineConfig(detector=tconfig.DetectorConfig(
        scale="n", img_size=64, num_classes=64, dtype="float32"), use_sam2=False)
    port = CircuitAnalyzerTorch(cfg, YOLOv11(64, "n").state_dict(), None, device="cpu",
                                vlm_client=None)
    return SimpleNamespace(cfg=jconfig.PipelineConfig()), port


@pytest.mark.parametrize("freq", [None, 1000.0])
@pytest.mark.parametrize("name", sorted(SIM_RESULTS))
@pytest.mark.parametrize("as_text", [False, True])
def test_analyzer_simulate_matches_jax(analyzers, name, as_text, freq):
    """CircuitAnalyzerTorch.simulate against CircuitAnalyzerTPU.simulate:
    an AnalysisResult takes the structured AC path (its '4:-45' and
    reactance values rewritten), netlist text the text path; DC or AC
    detected; the default frequency is cfg.sim.default_ac_frequency_hz."""
    jstub, port = analyzers
    rows, text = SIM_RESULTS[name]
    jarg = text if as_text else _result(JAX, rows, text)
    targ = text if as_text else _result(PORT, rows, text)
    want = _split(CircuitAnalyzerTPU.simulate(jstub, jarg, frequency_hz=freq))
    got = _split(port.simulate(targ, frequency_hz=freq))
    assert got == want
    if name == "ac-phasor" and not as_text:
        assert got[0][1], got  # the structured path solves what the text path cannot
        assert f"{freq or 60.0}" in got[0][3]


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """A g++ build that fails raises out of the engine; it does not fall
    back to the numpy solver (the JAX package's engine would)."""
    import subprocess

    broken = tmp_path / "solver.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SRC", broken)
    tnative.load_library.cache_clear()
    try:
        with pytest.raises(subprocess.CalledProcessError):
            tengine.perform_dc_analysis("V1 1 0 10\nR1 1 0 1k")
        with pytest.raises(subprocess.CalledProcessError):
            tengine.perform_ac_analysis_text("V1 1 0 AC 1 0\nR1 1 0 1k", 60.0)
        ok = tengine.perform_dc_analysis("V1 1 0 10\nR1 1 0 1k",
                                         tconfig.SimConfig(prefer_native=False))
        assert ok.ok and ok.node_voltages == {"1": "10.000V"}
    finally:
        monkeypatch.undo()
        tnative.load_library.cache_clear()
    assert tengine.perform_dc_analysis("V1 1 0 10\nR1 1 0 1k").ok
