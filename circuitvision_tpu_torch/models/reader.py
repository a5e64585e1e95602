"""The trained crop reader: component class, printed value and polarity
from one crop, in PyTorch.

Counterpart of the model half of the JAX package's `train/reader.py`
(:44-200): its constants, `ReaderConfig`, `encode_value`/`decode_value`,
`CropReader`, `resize_crop`, `make_crop` and `make_value_window`. The
training half (loss, step, dataset) is not here (ROADMAP Queue A 11).

`CropReader` keeps flax's names (`conv0`, `ln0b`, `grid_proj`, ...), so
`models/bridge.state_dict_from_variables` maps the orbax checkpoint onto
it by name. It runs NCHW and copies the numerics of the flax module,
each of which can move an argmax:

  * a stride-2 3×3 `nn.Conv` with SAME padding on an even size pads 0
    before and 1 after (160 → 80 → 40 → 20 → 10); a stride-1 one pads 1
    on each side;
  * `nn.gelu` is the tanh approximation (flax's default);
  * `nn.LayerNorm` over the channels: eps 1e-6, float32 statistics in the
    fast-variance form E[x²] − mean², clamped at 0;
  * the 5×5 grid's 1×1 projection is flattened in NHWC order, after the
    global average ([gap, grid]);
  * the input is divided by 255 and mapped to [−1, 1].

`resize_crop` is cv2.resize(INTER_LINEAR) on uint8 without cv2: OpenCV's
fixed-point path, bit for bit (see its docstring).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import taxonomy
from ..core.types import BBox
from ..ops.image import resize_linear_u8

#: value alphabet; slot 0 of the value logits is the blank
VALUE_CHARS = "0123456789kMGunmp.:-"
BLANK = 0
MAX_VALUE_LEN = 8
DIRECTIONS = ("NONE", "UP", "DOWN", "LEFT", "RIGHT")
#: the 62 detector classes and the netlist-map names without detector ids
READER_CLASS_NAMES = tuple(sorted(set(taxonomy.CLASSES) | set(taxonomy.NETLIST_MAP)))
READER_CLASS_TO_ID = {n: i for i, n in enumerate(READER_CLASS_NAMES)}
#: native-resolution value windows; the direction crops' context pad
CROP_SIZE = 160
CROP_PAD = 26


@dataclasses.dataclass(frozen=True)
class ReaderConfig:
    crop_size: int = CROP_SIZE
    num_classes: int = len(READER_CLASS_NAMES)
    value_len: int = MAX_VALUE_LEN
    value_vocab: int = len(VALUE_CHARS) + 1  # + blank
    n_directions: int = len(DIRECTIONS)
    width: int = 48


def encode_value(value: Optional[str]) -> np.ndarray:
    """Value string → (MAX_VALUE_LEN,) int32 codes (0 = blank)."""
    out = np.zeros((MAX_VALUE_LEN,), np.int32)
    for i, ch in enumerate((value or "")[:MAX_VALUE_LEN]):
        idx = VALUE_CHARS.find(ch)
        out[i] = idx + 1 if idx >= 0 else 0
    return out


def decode_value(codes) -> Optional[str]:
    chars = []
    for c in np.asarray(codes):
        c = int(c)
        if c == BLANK:
            break
        chars.append(VALUE_CHARS[c - 1])
    return "".join(chars) or None


class ChannelLayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the channels of an NCHW tensor (float32)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(1, keepdim=True)
        var = torch.clamp((x * x).mean(1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight[:, None, None]
        return (x - mean) * mul + self.bias[:, None, None]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class CropReader(nn.Module):
    """(B, S, S, 3) uint8 crops → class (B, C), value (B, L, V) and
    direction (B, D) logits, float32."""

    def __init__(self, cfg: ReaderConfig = ReaderConfig()):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        c_in = 3
        for i, ch in enumerate((w, 2 * w, 4 * w, 8 * w)):
            setattr(self, f"conv{i}", nn.Conv2d(c_in, ch, 3, stride=2, bias=False))
            setattr(self, f"ln{i}", ChannelLayerNorm(ch))
            setattr(self, f"conv{i}b", nn.Conv2d(ch, ch, 3, padding=1, bias=False))
            setattr(self, f"ln{i}b", ChannelLayerNorm(ch))
            c_in = ch
        grid = (cfg.crop_size // 32) ** 2
        self.grid_proj = nn.Conv2d(8 * w, w, 1)
        self.trunk_out = nn.Linear(8 * w + grid * w, 8 * w)
        self.head_cls = nn.Linear(8 * w, cfg.num_classes)
        self.head_val = nn.Linear(8 * w, cfg.value_len * cfg.value_vocab)
        self.head_dir = nn.Linear(8 * w, cfg.n_directions)

    def forward(self, crops: torch.Tensor):
        x = crops.to(torch.float32) / 255.0
        x = (x * 2.0 - 1.0).permute(0, 3, 1, 2)
        for i in range(4):
            # SAME at stride 2 on an even size: 0 before, 1 after
            x = _gelu(getattr(self, f"ln{i}")(getattr(self, f"conv{i}")(F.pad(x, (0, 1, 0, 1)))))
            x = _gelu(getattr(self, f"ln{i}b")(getattr(self, f"conv{i}b")(x)))
        b = x.shape[0]
        gap = x.mean(dim=(2, 3))
        grid = self.grid_proj(F.avg_pool2d(x, 2)).permute(0, 2, 3, 1).reshape(b, -1)
        feat = _gelu(self.trunk_out(torch.cat([gap, grid], dim=-1)))
        cfg = self.cfg
        return (self.head_cls(feat),
                self.head_val(feat).reshape(b, cfg.value_len, cfg.value_vocab),
                self.head_dir(feat))


def resize_crop(crop: np.ndarray, size: int) -> np.ndarray:
    """uint8 (H, W[, C]) → (size, size[, C]), byte-equal to
    cv2.resize(crop, (size, size), interpolation=cv2.INTER_LINEAR) (the
    JAX package's `resize_crop`; ops/image.resize_linear_u8)."""
    return resize_linear_u8(crop, (size, size))


def make_crop(image: np.ndarray, box: BBox, pad: int = CROP_PAD,
              size: int = CROP_SIZE) -> np.ndarray:
    """Component crop with a context pad, resized to (size, size, 3)
    uint8; an empty crop is white."""
    h, w = image.shape[:2]
    x0, y0 = max(0, box.xmin - pad), max(0, box.ymin - pad)
    x1, y1 = min(w, box.xmax + pad), min(h, box.ymax + pad)
    if x1 <= x0 or y1 <= y0:
        return np.full((size, size, 3), 255, np.uint8)
    return resize_crop(image[y0:y1, x0:x1], size)


def make_value_window(image: np.ndarray, box: BBox, size: int = CROP_SIZE,
                      jitter: tuple = (0, 0)) -> np.ndarray:
    """Native-resolution (size, size) window centred on the box (plus an
    optional centre jitter), white-padded past the image's borders."""
    h, w = image.shape[:2]
    cx = (box.xmin + box.xmax) // 2 + int(jitter[0])
    cy = (box.ymin + box.ymax) // 2 + int(jitter[1])
    x0, y0 = cx - size // 2, cy - size // 2
    out = np.full((size, size, 3), 255, np.uint8)
    sx0, sy0 = max(0, x0), max(0, y0)
    sx1, sy1 = min(w, x0 + size), min(h, y0 + size)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = image[sy0:sy1, sx0:sx1]
    return out
