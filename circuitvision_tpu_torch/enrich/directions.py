"""Semantic direction enrichment (stage [4]).

Counterpart of the JAX package's `enrich/directions.py`
(`_collect_jobs`, `enrich_directions`, `enrich_directions_many`;
reference src/circuit_analyzer.py:2145-2215): each component of a
direction class gets its box padded by `EnrichConfig.crop_padding` cut
from the analysis image. A client with `get_directions_batch` (the
trained crop reader) reads every such crop of an image, or of a chunk,
in one call; any other client (the HTTP clients, the fake) reads one
crop a `get_direction` call, the calls of an image on a thread pool of
`EnrichConfig.max_concurrency` workers, and a chunk goes image by image.
A failed read gives UNKNOWN, as in JAX (the batch path logs it) —
except a kernel fault or a CUDA, cuDNN or cuBLAS error, which raises.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
from typing import Optional, Sequence

import numpy as np

from ..core import taxonomy
from ..core.config import EnrichConfig
from ..core.types import BBox
from ..ops.cuda.build import is_device_fault
from .client import VLMClient

logger = logging.getLogger(__name__)
_UNKNOWN = ("UNKNOWN", "UNKNOWN")


def _collect_jobs(image_rgb: np.ndarray, out: list[BBox], cfg: EnrichConfig,
                  debug_store: Optional[dict]) -> list[tuple[int, np.ndarray, str]]:
    """Mark ineligible and degenerate boxes in place; return the reads
    (box index, padded crop, class) of the eligible ones."""
    h, w = image_rgb.shape[:2]
    jobs: list[tuple[int, np.ndarray, str]] = []
    for i, b in enumerate(out):
        if b.class_name not in taxonomy.DIRECTION_CLASSES:
            b.semantic_direction = None
            b.semantic_reason = None
            continue
        x0, y0 = max(0, b.xmin - cfg.crop_padding), max(0, b.ymin - cfg.crop_padding)
        x1, y1 = min(w, b.xmax + cfg.crop_padding), min(h, b.ymax + cfg.crop_padding)
        crop = image_rgb[y0:y1, x0:x1]
        if x0 >= x1 or y0 >= y1 or crop.size == 0:
            b.semantic_direction, b.semantic_reason = _UNKNOWN
            continue
        if debug_store is not None:
            debug_store[b.persistent_uid] = crop
        jobs.append((i, crop, b.class_name))
    return jobs


def _read_batch(client, crops: list, classes: list) -> list[tuple[str, str]]:
    read = client.get_directions_batch
    try:
        return read(crops, classes)
    except Exception as exc:
        if is_device_fault(exc):
            raise
        logger.error("direction read of %d crops failed: %s; reading UNKNOWN", len(crops), exc)
        return [_UNKNOWN] * len(crops)


def _read_each(client, jobs: list, cfg: EnrichConfig) -> list[tuple[str, str]]:
    """One get_direction call a crop, on a pool of at most
    cfg.max_concurrency threads (JAX :98-110); a call that raises reads
    UNKNOWN."""
    def run(job):
        _i, crop, cls = job
        try:
            return client.get_direction(crop, cls)
        except Exception as exc:
            if is_device_fault(exc):
                raise
            return _UNKNOWN

    workers = max(1, min(cfg.max_concurrency, len(jobs)))
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(run, jobs))


def enrich_directions(image_rgb: np.ndarray, bboxes: Sequence[BBox],
                      client: Optional[VLMClient], cfg: Optional[EnrichConfig] = None,
                      debug_store: Optional[dict] = None) -> list[BBox]:
    """New boxes with semantic_direction/reason filled (None for classes
    without a direction; left unset by no client). `debug_store`
    receives each read crop under its component's persistent_uid."""
    cfg = cfg or EnrichConfig()
    out = [dataclasses.replace(b) for b in bboxes]
    if client is None:
        return out
    jobs = _collect_jobs(image_rgb, out, cfg, debug_store)
    if not jobs:
        return out
    if getattr(client, "get_directions_batch", None) is not None:
        answers = _read_batch(client, [c for _, c, _ in jobs], [k for _, _, k in jobs])
    else:
        answers = _read_each(client, jobs, cfg)
    for (i, _, _), (direction, reason) in zip(jobs, answers):
        out[i].semantic_direction, out[i].semantic_reason = direction, reason
    return out


def enrich_directions_many(images: Sequence[np.ndarray], boxes_lists: Sequence[Sequence[BBox]],
                           client: Optional[VLMClient], cfg: Optional[EnrichConfig] = None,
                           debug_stores: Optional[Sequence[Optional[dict]]] = None
                           ) -> list[list[BBox]]:
    """Stage [4] over a chunk: every eligible crop of every image in one
    get_directions_batch call; a client without it goes image by image
    (JAX :134-138)."""
    cfg = cfg or EnrichConfig()
    stores = debug_stores if debug_stores is not None else [None] * len(images)
    if client is None or getattr(client, "get_directions_batch", None) is None:
        return [enrich_directions(img, bl, client, cfg, ds)
                for img, bl, ds in zip(images, boxes_lists, stores)]
    outs = [[dataclasses.replace(b) for b in bl] for bl in boxes_lists]
    jobs = [(k, i, crop, cls)
            for k, (img, out, ds) in enumerate(zip(images, outs, stores))
            for i, crop, cls in _collect_jobs(img, out, cfg, ds)]
    if not jobs:
        return outs
    answers = _read_batch(client, [c for _, _, c, _ in jobs], [c for _, _, _, c in jobs])
    for (k, i, _, _), (direction, reason) in zip(jobs, answers):
        outs[k][i].semantic_direction, outs[k][i].semantic_reason = direction, reason
    return outs
