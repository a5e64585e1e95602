"""Logging, stage timing and device profiling: the JAX package's
`core/logging_util.py` in torch.

Reference behavior: the level from LOG_LEVEL (app.py:36-45), third-party
logger suppression (app.py:47-57), the per-stage analysis summary
(src/analysis_pipeline.py:328-347). `stage_timer` records a stage's
wall-clock seconds; `device_trace` wraps `torch.profiler` (CPU and, when
there is a card, CUDA activity) where the JAX package wraps jax.profiler,
and writes a Chrome trace into its log directory.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time

_NOISY_LOGGERS = ("urllib3", "PIL", "matplotlib", "httpx", "openai", "google")


def configure_logging(level: str | None = None) -> logging.Logger:
    level_name = (level or os.getenv("LOG_LEVEL", "INFO")).upper()
    logging.basicConfig(
        level=getattr(logging, level_name, logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    for name in _NOISY_LOGGERS:
        logging.getLogger(name).setLevel(logging.WARNING)
    return logging.getLogger("circuitvision_tpu_torch")


@contextlib.contextmanager
def stage_timer(timings: dict, stage: str):
    """Record wall-clock for a pipeline stage into a timings dict
    (reference detailed_timings pattern, src/analysis_pipeline.py:99-113)."""
    start = time.time()
    try:
        yield
    finally:
        timings[stage] = time.time() - start


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler over the block, its Chrome trace written to
    `log_dir`/trace.json (open in chrome://tracing or Perfetto). Yields
    the profiler; CUDA activity is traced when a card is present."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def log_analysis_summary(result, logger: logging.Logger) -> None:
    """Per-class component counts + node count at INFO
    (src/analysis_pipeline.py:328-347)."""
    if not result.netlist:
        return
    counts: dict[str, int] = {}
    for line in result.netlist:
        counts[line.class_name] = counts.get(line.class_name, 0) + 1
    logger.info("Analysis results summary:")
    logger.info("- Total components detected: %d", len(result.netlist))
    for cls, n in counts.items():
        logger.info("  - %s: %d", cls, n)
    if result.nodes:
        logger.info("- Total nodes: %d", len(result.nodes))
