"""The port's small leftovers against the JAX package on the CPU:
`ops/skeleton.skeletonize` (bool-equal to the JAX package's on the golden
circuit test's thin wire, a full-frame mask and seeded random masks) and
`core/logging_util` (the analysis summary's log lines, the level from
LOG_LEVEL, the stage timer, and `device_trace` writing a trace file)."""
import json
import logging
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from circuitvision_tpu.core import logging_util as jlog
from circuitvision_tpu.ops.skeleton import skeletonize as jskeletonize
from circuitvision_tpu_torch.core import logging_util as tlog
from circuitvision_tpu_torch.ops.skeleton import skeletonize


def _masks():
    thin = np.zeros((40, 80), np.uint8)
    thin[18:25, 10:70] = 255  # tests/test_golden_circuit.py:130's 7 px wire
    rng = np.random.default_rng(0)
    out = {"thin line": (thin, 64), "full frame": (np.full((30, 44), 255, np.uint8), 64),
           "one pixel": (np.pad(np.ones((1, 1), bool), 3), 64), "empty": (np.zeros((9, 9)), 64)}
    for i, (h, w, p, iters) in enumerate([(37, 53, 0.6, 64), (64, 48, 0.8, 64),
                                          (25, 31, 0.5, 2)]):
        out[f"random {i}"] = ((rng.random((h, w)) < p).astype(np.uint8) * 255, iters)
    return out


MASKS = _masks()


@pytest.mark.parametrize("name", sorted(MASKS))
def test_skeletonize_equals_jax(name):
    mask, iters = MASKS[name]
    want = np.asarray(jskeletonize(mask, max_iters=iters))
    got = skeletonize(mask, max_iters=iters, device="cpu")
    assert got.dtype == torch.bool and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # a tensor stays on its device
    np.testing.assert_array_equal(skeletonize(torch.from_numpy(np.asarray(mask)),
                                              max_iters=iters).numpy(), want)


def test_skeleton_thin_line():
    """tests/test_golden_circuit.py's pins: thin, inside the wire."""
    mask = MASKS["thin line"][0]
    skel = skeletonize(mask, device="cpu").numpy()
    assert skel.any() and skel[:, 20:60].sum(axis=0).max() <= 2
    assert not skel[~(mask > 0)].any()


def test_skeletonize_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        skeletonize(MASKS["thin line"][0])


def _result(classes, nodes):
    return SimpleNamespace(netlist=[SimpleNamespace(class_name=c) for c in classes],
                           nodes=list(range(nodes)))


@pytest.mark.parametrize("classes, nodes", [
    (["resistor", "voltage.dc", "resistor", "capacitor"], 3), (["resistor"], 0), ([], 4)])
def test_log_analysis_summary_lines(caplog, classes, nodes):
    lines = []
    for mod in (jlog, tlog):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="summary"):
            mod.log_analysis_summary(_result(classes, nodes), logging.getLogger("summary"))
        lines.append([(r.levelno, r.getMessage()) for r in caplog.records])
    assert lines[1] == lines[0]
    assert bool(lines[0]) == bool(classes)


@pytest.mark.parametrize("env, level", [("DEBUG", logging.DEBUG), ("warning", logging.WARNING),
                                        ("bogus", logging.INFO), (None, logging.INFO)])
def test_configure_logging_level(monkeypatch, env, level):
    """The root level from LOG_LEVEL (an unknown name → INFO), the noisy
    loggers at WARNING, as the JAX package sets them."""
    if env is None:
        monkeypatch.delenv("LOG_LEVEL", raising=False)
    else:
        monkeypatch.setenv("LOG_LEVEL", env)
    root = logging.getLogger()
    saved_handlers, saved_level = root.handlers[:], root.level
    noisy = {n: logging.getLogger(n).level for n in tlog._NOISY_LOGGERS}
    got = {}
    try:
        for mod in (jlog, tlog):
            root.handlers = []  # basicConfig configures a root with no handlers only
            logger = mod.configure_logging()
            got[mod] = (root.level, {n: logging.getLogger(n).level for n in noisy})
            root.handlers = []
            root.setLevel(saved_level)
    finally:
        root.handlers = saved_handlers
        root.setLevel(saved_level)
        for n, lv in noisy.items():
            logging.getLogger(n).setLevel(lv)
    assert got[tlog] == got[jlog] and got[tlog][0] == level
    assert logger.name == "circuitvision_tpu_torch"
    assert tlog._NOISY_LOGGERS == jlog._NOISY_LOGGERS


def test_stage_timer_records_on_error():
    timings = {}
    with pytest.raises(ZeroDivisionError):
        with tlog.stage_timer(timings, "stage"):
            time.sleep(0.01)
            1 / 0
    assert timings["stage"] >= 0.01


def test_device_trace_writes_a_trace(tmp_path):
    with tlog.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("mm" in str(n) for n in names)
