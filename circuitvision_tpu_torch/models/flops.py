"""FLOP count of the device path, for the share of peak (MFU).

Counterpart of the JAX package's `models/flops.py`, which walks a jaxpr
and counts `dot_general` and `conv_general_dilated` only — the
contractions, the usual "model FLOPs" (elementwise work and reductions
are left out by convention). The port counts the same contractions with
`torch.utils.flop_counter.FlopCounterMode` over the module path: the
ctypes kernels are invisible to it (they compute the same contractions
as the module path they replace, so the module path's count stands for
both), so the models run under `hiera.force_fused(False)` and, as the
JAX count disables flash attention, einsum attention
(`hiera.force_flash(False)`). The models run on the meta device by
default, which needs no memory and no arithmetic; the CPU works too.

Where the two libraries count an operation differently, the port takes
the JAX package's convention:

  * a transposed convolution counts 2 · output elements · kernel taps ·
    input channels / groups, as `conv_general_dilated` with an lhs
    dilation does — over the output's spatial size, not the input's
    (FlopCounterMode's own formula);
  * attention is its two einsums, whatever kernel runs it;
  * the mask decoder's object-score head, which the JAX decoder runs and
    the port's skips (nothing reads its output), is added from its
    layers' shapes.

The interpolations agree without help: the logits' linear resize is a
contraction with one weight matrix per axis in both packages
(`ops/image.resize_linear`, jax.image.resize), the position embedding's
bicubic resize and the nearest-neighbour upsamplings a gather in both.

`device_peak_flops` reads the card's name: an H100 SXM gives NVIDIA's
dense peaks, 989 TFLOP/s in bf16 and 67 in float32; any other device
None.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

#: dense peak FLOP/s of the cards the port knows, by the start of
#: torch.cuda.get_device_name (NVIDIA H100 SXM data sheet)
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": {torch.bfloat16: 989e12, torch.float32: 67e12}}

_aten = torch.ops.aten


def device_peak_flops(device=None, dtype: torch.dtype = torch.bfloat16) -> Optional[float]:
    """Peak dense FLOP/s of a CUDA `device` (default: the current one) in
    `dtype`, or None for a device or dtype this table does not hold."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for kind, peaks in PEAK_FLOPS.items():
        if name.startswith(kind):
            return peaks.get(dtype)
    return None


def _convolution_flops(x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
                       _output_padding, groups, *_, out_shape=None, **__) -> int:
    """aten.convolution as the JAX count takes conv_general_dilated: a
    transposed convolution over its output's spatial size, 2 · output
    elements · kernel taps · input channels / groups."""
    if not transposed:
        return conv_flop_count(x_shape, w_shape, out_shape, transposed=False)
    return 2 * math.prod(out_shape) * math.prod(w_shape[2:]) * (x_shape[1] // groups)


_CUSTOM = {_aten.convolution: _convolution_flops}


def matmul_flops(fn, *args) -> int:
    """Total contraction FLOPs of one call of `fn(*args)`: matrix
    products, einsums and convolutions, as FlopCounterMode sees them
    (transposed convolutions by the JAX convention)."""
    with FlopCounterMode(display=False, custom_mapping=_CUSTOM) as counter:
        fn(*args)
    return int(counter.get_total_flops())


@contextlib.contextmanager
def _module_path():
    from .sam2 import hiera

    with hiera.force_fused(False), hiera.force_flash(False):
        yield


def sam2_forward_flops(cfg, batch: int = 1, device: str = "meta") -> int:
    """Contraction FLOPs of one SAM2 forward at cfg.resolution, float32
    (the module path: the kernels compute the same contractions)."""
    from .sam2.wrapper import SAM2ImageSegmenter

    with torch.device(device):
        model = SAM2ImageSegmenter(cfg).eval()
        x = torch.zeros((batch, cfg.resolution, cfg.resolution, 3))
    with torch.no_grad(), _module_path():
        total = matmul_flops(model, x)
    return total + _object_score_flops(model, batch)


def _object_score_flops(model, batch: int) -> int:
    """The JAX decoder's object-score head on one token per image: its
    linear layers, 2 · batch · in · out each."""
    head = getattr(model.sam_mask_decoder, "pred_obj_score_head", None)
    if head is None:
        return 0
    return sum(2 * batch * m.in_features * m.out_features
               for m in head.modules() if isinstance(m, torch.nn.Linear))


def yolo_forward_flops(det_cfg, batch: int = 1, device: str = "meta") -> int:
    """Contraction FLOPs of one YOLO forward + DFL decode at
    det_cfg.img_size, float32."""
    from .yolo.decode import decode_predictions
    from .yolo.model import YOLOv11

    with torch.device(device):
        model = YOLOv11(det_cfg.num_classes, det_cfg.scale, det_cfg.reg_max).eval()
        x = torch.zeros((batch, det_cfg.img_size, det_cfg.img_size, 3))

    def fwd(img):
        return decode_predictions(model(img), det_cfg.reg_max, det_cfg.num_classes)

    with torch.no_grad():
        return matmul_flops(fwd, x)

