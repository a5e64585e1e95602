"""Terminal reclassification from preliminary connectivity.

Counterpart of the JAX package's `topology/reclassify.py` (reference
reclassify_terminals_based_on_connectivity,
src/circuit_analyzer.py:2217-2311): a classical adaptive-threshold mask
of the image, component boxes subtracted, contours at the smaller 1e-4
area threshold, and any 'terminal' touching >= 2 distinct contours
(10 px threshold, no rect broad phase) relabelled 'voltage.dc'.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import taxonomy
from ..core.config import TopologyConfig, resolve_device
from ..core.types import BBox
from ..ops.image import adaptive_threshold_mean_inv, rgb_to_gray
from .host_cc import contour_touch_stage_host
from .nodes import _comp_bucket, subtract_component_boxes


def segment_classical(image_rgb: np.ndarray, cfg: Optional[TopologyConfig] = None,
                      swap_rb: bool = False, device="cuda") -> np.ndarray:
    """Classical wire mask: grayscale → adaptive mean threshold, inverted
    (reference segment_circuit, src/circuit_analyzer.py:313-319).

    swap_rb reproduces the reference reclassify path's channel quirk
    (RGB→BGR, then COLOR_RGB2GRAY on the BGR image, :2234-2238).
    """
    device = resolve_device(device, "segment_classical")
    cfg = cfg or TopologyConfig()
    img = torch.as_tensor(np.ascontiguousarray(image_rgb), device=device)
    if swap_rb:
        img = img.flip(-1)
    mask = adaptive_threshold_mean_inv(rgb_to_gray(img), cfg.adaptive_block, float(cfg.adaptive_c))
    return mask.cpu().numpy()


def reclassify_terminals(image_rgb: np.ndarray, bboxes: Sequence[BBox],
                         cfg: Optional[TopologyConfig] = None, device="cuda") -> list[BBox]:
    """A new bbox list with multi-connected terminals relabelled
    'voltage.dc'. The threshold runs on `device`, the contour/touch stage
    on the host."""
    device = resolve_device(device, "reclassify_terminals")
    cfg = cfg or TopologyConfig()
    out = [dataclasses.replace(b) for b in bboxes]
    terminal_idx = [i for i, b in enumerate(out) if b.class_name == "terminal"]
    if not terminal_idx:
        return out

    mask = segment_classical(image_rgb, cfg, swap_rb=True, device=device)
    wire = subtract_component_boxes(mask, out)
    _h, w = wire.shape

    bucket = _comp_bucket(len(terminal_idx))
    comp_boxes = np.zeros((bucket, 4), np.float32)
    comp_thr = np.full(bucket, float(cfg.reclass_pixel_threshold), np.float32)
    comp_valid = np.zeros(bucket, bool)
    for col, i in enumerate(terminal_idx):
        b = out[i]
        comp_boxes[col] = (b.xmin, b.ymin, b.xmax, b.ymax)
        comp_valid[col] = True

    fg = wire != 0
    if wire.mean() > 127.0:  # auto-invert (get_contours semantics, :398)
        fg = ~fg
    _cen, _rel, touch, _cts = contour_touch_stage_host(
        fg, float(w), cfg, comp_boxes, comp_thr, comp_valid,
        area_threshold=cfg.prelim_contour_area_threshold, broad_phase=False,
    )
    touch = touch[:, : len(terminal_idx)]
    for col, i in enumerate(terminal_idx):
        if int(touch[:, col].sum()) >= cfg.reclass_min_connections:
            b = out[i]
            b.original_class_if_reclassified = b.class_name
            b.class_name = "voltage.dc"
            b.class_id = taxonomy.CLASSES.get("voltage.dc", b.class_id)
            b.was_reclassified_from_terminal = True
    return out
