"""Serving client of the trained crop reader (models/reader.py).

Counterpart of the JAX package's `enrich/trained_reader.py`: the
duck-typed hooks the pipeline calls on a VLM client —
`get_labels_batch_boxes` for the stage-2 value pass and
`get_directions_batch` for stage [4] — answered by one batched forward
of the reader per call, with no external service. The crops are padded
to the JAX client's power-of-two buckets (jobs beyond 256 run as
256-crop sub-batches), uploaded as uint8, and each head's argmax is
taken on the device, so the fetch is one small int array. The JAX
client's multi-view averaging, which its serving path never takes
(one centred window a job), is not ported.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core import taxonomy
from ..core.config import resolve_device
from ..core.types import BBox
from ..models.bridge import state_dict_from_variables
from ..models.checkpoint import load_variables
from ..models.reader import (
    DIRECTIONS, READER_CLASS_NAMES, CropReader, ReaderConfig, decode_value, make_value_window,
    resize_crop,
)

#: batch buckets (JAX trained_reader.py:40)
_BUCKETS = (8, 16, 32, 64, 128, 256)


def _reason_for(cls: str) -> str:
    """ARROW for diodes and current sources, SIGN for the +/− marked."""
    if cls in taxonomy.DIODE_CLASSES or cls in taxonomy.CURRENT_SOURCE_CLASSES:
        return "ARROW"
    return "SIGN"


class TrainedReaderClient:
    """VLM-client hooks backed by a trained CropReader on `device` (CUDA
    unless the CPU is asked for)."""

    def __init__(self, state_dict: dict, cfg: Optional[ReaderConfig] = None, device="cuda"):
        self.device = resolve_device(device, "TrainedReaderClient")
        self.cfg = cfg or ReaderConfig()
        self.model = CropReader(self.cfg)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def _read_crops(self, crops: np.ndarray):
        """(N, S, S, 3) uint8 → per crop (class name, value, direction)."""
        total = crops.shape[0]
        cap = _BUCKETS[-1]
        bucket = next((b for b in _BUCKETS if b >= total), cap)
        padded = bucket if total <= cap else -(-total // cap) * cap
        if padded > total:
            crops = np.concatenate([crops, np.zeros((padded - total, *crops.shape[1:]),
                                                    crops.dtype)])
        x = torch.as_tensor(np.ascontiguousarray(crops), device=self.device)
        ids = []
        for s in range(0, padded, cap):
            cls_l, val_l, dir_l = self.model(x[s:s + cap])
            ids.append(torch.cat([cls_l.argmax(-1)[:, None], val_l.argmax(-1),
                                  dir_l.argmax(-1)[:, None]], dim=1))
        ids = torch.cat(ids)[:total].cpu().numpy()  # the one fetch: (N, 1 + L + 1) ints
        cls_ids, val_codes, dir_ids = ids[:, 0], ids[:, 1:-1], ids[:, -1]
        classes = [READER_CLASS_NAMES[int(c)] if 0 <= int(c) < len(READER_CLASS_NAMES)
                   else "unknown" for c in cls_ids]
        return classes, [decode_value(v) for v in val_codes], [DIRECTIONS[int(d)] for d in dir_ids]

    def get_labels_batch_boxes(self, enum_images: Sequence[np.ndarray],
                               enum_boxes_lists: Sequence[Sequence[BBox]]
                               ) -> list[list[dict]]:
        """Every id'd box of every image in one read: per image the
        stage-2 rows [{'id', 'class', 'value'}], from one centred value
        window a box."""
        jobs = [(i, b) for i, boxes in enumerate(enum_boxes_lists) for b in boxes or []
                if b.visual_id is not None]
        if not jobs:
            return [[] for _ in enum_images]
        crops = np.stack([make_value_window(enum_images[i], b) for i, b in jobs])
        classes, values, _dirs = self._read_crops(crops)
        out: list[list[dict]] = [[] for _ in enum_images]
        for (i, b), cls, val in zip(jobs, classes, values):
            out[i].append({"id": str(b.visual_id), "class": cls, "value": val})
        return out

    def get_labels(self, enum_image_rgb: np.ndarray) -> list[dict]:
        """The whole-image read of a black-box VLM; this reader is
        box-driven and the pipeline calls get_labels_batch_boxes."""
        raise NotImplementedError(
            "TrainedReaderClient reads per-component crops; the pipeline "
            "should call get_labels_batch_boxes (it does when enum boxes "
            "are available)"
        )

    def get_directions_batch(self, crops: Sequence[np.ndarray],
                             classes: Sequence[str]) -> list[tuple[str, str]]:
        """(direction, reason) per padded component crop, each resized to
        the reader's size as cv2 would; NONE reads as UNKNOWN."""
        size = self.cfg.crop_size
        _cls, _vals, dirs = self._read_crops(np.stack([resize_crop(c, size) for c in crops]))
        return [(d if d != "NONE" else "UNKNOWN", _reason_for(cls))
                for d, cls in zip(dirs, classes)]


def load_trained_reader(path: str, device="cuda") -> TrainedReaderClient:
    """The reader of an orbax checkpoint directory (ckpt/reader), read by
    the port's own checkpoint reader, on `device`."""
    return TrainedReaderClient(state_dict_from_variables(load_variables(path)), device=device)
