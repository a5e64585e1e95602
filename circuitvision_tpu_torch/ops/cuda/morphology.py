"""Line enhancement as one kernel: blur 5×5 σ1 → round → dilate 3×3 ×2 →
erode 3×3 ×2, each stage with cv2's replicate border at the true image
edge.

Replaces the JAX package's Pallas kernel `enhance_lines_fused`
(circuitvision_tpu/ops/pallas/fused_morphology.py); the CUDA source is
csrc/morphology.cu, whose header note says what bounds it on the H100
and how the design answers that. `enhance_lines_fused_plain` is the same
function in plain PyTorch with the kernel's numerics — the Pallas
kernel's float64-built taps (`TAPS`), products and sums rounded one at a
time in the kernel's order, round half to even — so on the card the two
agree bit for bit. Note that `TAPS` are not `ops.morphology`'s taps,
which are built in float32: four of the five differ by one float32 ulp,
so this function is not `round(enhance_lines(x))` bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..morphology import dilate, erode
from .build import KernelError, check, check_no_grad, library, stream_ptr


def _taps() -> tuple[float, ...]:
    """5-tap σ=1 Gaussian as fused_morphology.py:131-135 builds it: float64,
    normalised, then rounded to float32 where the kernel multiplies."""
    xs = np.arange(5, dtype=np.float64) - 2.0
    k = np.exp(-(xs**2) / 2.0)
    return tuple(float(t) for t in (k / k.sum()).astype(np.float32))


TAPS = _taps()


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Separable blur with replicate borders: horizontal taps summed left
    to right, then vertical taps top to bottom."""
    h, w = x.shape
    xp = F.pad(x[None, None], (2, 2, 0, 0), mode="replicate")[0, 0]
    hz = TAPS[0] * xp[:, 0:w]
    for i in range(1, 5):
        hz = hz + TAPS[i] * xp[:, i:i + w]
    hp = F.pad(hz[None, None], (0, 0, 2, 2), mode="replicate")[0, 0]
    out = TAPS[0] * hp[0:h]
    for i in range(1, 5):
        out = out + TAPS[i] * hp[i:i + h]
    return out


def enhance_lines_fused_plain(mask: torch.Tensor) -> torch.Tensor:
    x = torch.round(_blur(mask.to(torch.float32)))
    return erode(dilate(x, 3, 2), 3, 2)


def enhance_lines_fused(mask: torch.Tensor) -> torch.Tensor:
    """mask (H, W) float32, values 0..255. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if mask.device.type == "cpu":
        return enhance_lines_fused_plain(mask)
    if mask.dtype != torch.float32 or mask.dim() != 2 or not mask.is_contiguous() \
            or not mask.is_cuda:
        raise KernelError(f"enhance_lines_fused: needs a contiguous (H, W) float32 CUDA "
                          f"tensor; got {mask.dtype} {tuple(mask.shape)} on {mask.device}")
    check_no_grad("enhance_lines_fused", mask)
    h, w = mask.shape
    out = torch.empty_like(mask)
    err = library("morphology").cv_enhance_lines(
        mask.data_ptr(), out.data_ptr(), h, w, *TAPS, stream_ptr(mask))
    check(err, "enhance_lines_fused")
    enhance_lines_fused.launches += 1
    return out


enhance_lines_fused.launches = 0
