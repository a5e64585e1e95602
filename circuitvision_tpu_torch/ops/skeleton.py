"""Morphological skeletonization (wire centerline extraction): the JAX
package's `ops/skeleton.py` in torch.

    S(X) = union_k [ erode^k(X) minus open(erode^k(X)) ]

over the port's `ops/morphology.erode/dilate` (3×3 ones kernel), on the
mask's device. The JAX version is a jitted `lax.while_loop` with no
Pallas kernel; here the loop runs on the host, reading one flag a step.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.config import resolve_device
from .morphology import dilate, erode


def _erode0(v: torch.Tensor) -> torch.Tensor:
    # Erosion must treat outside-image as BACKGROUND (constant-0 border),
    # or foreground touching the frame never erodes from that side and a
    # full-frame mask skeletonizes to nothing. morphology.erode replicates
    # the border (cv2 parity); with a 3x3 kernel, zero-padded erosion ==
    # replicate erosion with the border ring forced to zero.
    e = erode(v, 3, 1)
    e[0, :] = 0.0
    e[-1, :] = 0.0
    e[:, 0] = 0.0
    e[:, -1] = 0.0
    return e


def skeletonize(mask, max_iters: int = 64, device="cuda") -> torch.Tensor:
    """Binary morphological skeleton. mask: (H, W) bool/0-255, a tensor
    (run on its own device) or an array (moved to `device`: the card
    unless "cpu" is asked for). Returns the bool skeleton of 1-2 px wide
    centerlines."""
    if isinstance(mask, torch.Tensor):
        x = mask
    else:
        x = torch.as_tensor(np.asarray(mask), device=resolve_device(device, "skeletonize"))
    cur = (x > 0).to(torch.float32) * 255.0
    skel = torch.zeros_like(cur)
    it = 0
    while bool((cur > 0).any()) and it < max_iters:
        eroded = _erode0(cur)
        opened = dilate(eroded, 3, 1)
        skel = torch.maximum(skel, torch.clamp(cur - opened, min=0.0))
        cur, it = eroded, it + 1
    return skel > 0
