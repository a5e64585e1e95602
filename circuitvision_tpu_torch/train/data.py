"""Real-dataset loading for SAM2 fine-tuning — the JAX package's
`train/data.py` in PyTorch.

A folder of (image, mask) pairs → deterministic shuffled epochs →
preprocessed batches with a background prefetch thread, sharded per
process. Layout::

    <root>/images/<name>.png|jpg|jpeg|bmp|webp
    <root>/masks/<name>.png          (nonzero pixel = wire)

Images decode with the port's `io/image_io.load_image` and go through
`ops/image.sam2_preprocess` (ToTensor → bilinear resize → ImageNet
normalize) on the device the caller names; masks are nearest-resized to
the model resolution and binarized. The 8 dihedral augment codes, the
epoch permutations and the shard split are the JAX package's, so both
yield the same batches.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import torch

from ..core.config import resolve_device

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


class SegmentationFolderDataset:
    """(image, mask) pairs from ``<root>/images`` + ``<root>/masks``.
    Batches are made on `device` (CUDA unless "cpu" is asked for)."""

    def __init__(self, root: str, resolution: int = 1024, device="cuda"):
        self.root = root
        self.resolution = resolution
        self.device = resolve_device(device, "SegmentationFolderDataset")
        img_dir = os.path.join(root, "images")
        mask_dir = os.path.join(root, "masks")
        if not os.path.isdir(img_dir) or not os.path.isdir(mask_dir):
            raise FileNotFoundError(f"expected {root}/images and {root}/masks directories")
        self.items: list = []
        for f in sorted(os.listdir(img_dir)):
            stem, ext = os.path.splitext(f)
            if ext.lower() not in _IMG_EXTS:
                continue
            mask_path = None
            for mext in (".png",) + _IMG_EXTS:
                cand = os.path.join(mask_dir, stem + mext)
                if os.path.exists(cand):
                    mask_path = cand
                    break
            if mask_path is None:
                raise FileNotFoundError(f"no mask for image {f} in {mask_dir}")
            self.items.append((os.path.join(img_dir, f), mask_path))
        if not self.items:
            raise FileNotFoundError(f"no images found under {img_dir}")

    def __len__(self) -> int:
        return len(self.items)

    def load_raw(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(RGB uint8 (H, W, 3), mask uint8 (H, W)) at native size."""
        from ..io.image_io import load_image

        img = load_image(self.items[i][0])
        mask = load_image(self.items[i][1])
        if mask.ndim == 3:
            mask = mask.max(axis=-1)
        return img, (mask > 0).astype(np.uint8)

    def load(self, i: int, augment_code: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
        """Preprocessed (image (S, S, 3) float32, mask (S, S) float32) on
        the dataset's device. ``augment_code`` ∈ [0, 8): bit 0 = horizontal
        flip, bit 1 = vertical flip, bit 2 = transpose — the 8 dihedral
        symmetries, applied identically to image and mask before
        preprocessing."""
        from ..ops.image import sam2_preprocess

        img, mask = self.load_raw(i)
        if augment_code & 1:
            img, mask = img[:, ::-1], mask[:, ::-1]
        if augment_code & 2:
            img, mask = img[::-1], mask[::-1]
        if augment_code & 4:
            img, mask = img.transpose(1, 0, 2), mask.transpose(1, 0)
        s = self.resolution
        pre = sam2_preprocess(torch.from_numpy(np.ascontiguousarray(img)).to(self.device), s)
        # Nearest-neighbor target resize keeps the mask binary.
        ys = (np.arange(s) * (mask.shape[0] / s)).astype(np.int32)
        xs = (np.arange(s) * (mask.shape[1] / s)).astype(np.int32)
        m = torch.from_numpy(mask[ys][:, xs].astype(np.float32)).to(self.device)
        return pre, m

    def batches(self, batch_size: int, *, seed: int = 0, epochs: int | None = 1,
                augment: bool = False, shard: tuple[int, int] | None = None,
                drop_remainder: bool = True,
                prefetch: int = 2) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """Yield (images (B, S, S, 3), masks (B, S, S)) float32 batches.

        Deterministic: epoch e uses the permutation seeded ``seed + e`` and
        per-sample augmentation codes from the same numpy stream, so any
        (seed, shard) pair reproduces exactly. ``shard=(index, count)``
        partitions each epoch's permutation round-robin, every shard's
        stream of the same length; ``batch_size`` is then the per-process
        batch. ``epochs=None`` iterates forever. A background thread
        prefetches and preprocesses the next ``prefetch`` batches."""
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        idx_self, n_shards = shard if shard is not None else (0, 1)
        if not (0 <= idx_self < n_shards):
            raise ValueError(f"bad shard {shard}")

        def epoch_indices(e: int) -> Sequence[tuple[int, int]]:
            rng = np.random.default_rng(seed + e)
            perm = rng.permutation(len(self.items))
            codes = (rng.integers(0, 8, size=len(self.items)) if augment
                     else np.zeros(len(self.items), np.int64))
            pairs = list(zip(perm.tolist(), codes.tolist()))
            # every shard's stream the same length: lockstep collectives
            usable = (len(pairs) // n_shards) * n_shards
            return pairs[:usable][idx_self::n_shards]

        # a consumer that abandons the generator must release the producer,
        # which otherwise blocks forever on the bounded queue
        stop = threading.Event()

        def put(out_q: queue.Queue, item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def stack(pending):
            return torch.stack([p[0] for p in pending]), torch.stack([p[1] for p in pending])

        def produce(out_q: queue.Queue):
            try:
                e = 0
                while epochs is None or e < epochs:
                    pending = []
                    for i, code in epoch_indices(e):
                        if stop.is_set():
                            return
                        pending.append(self.load(i, code))
                        if len(pending) == batch_size:
                            if not put(out_q, stack(pending)):
                                return
                            pending = []
                    if pending and not drop_remainder and not put(out_q, stack(pending)):
                        return
                    e += 1
            except Exception as exc:  # surfaced to the consumer
                put(out_q, exc)
            put(out_q, None)

        q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
