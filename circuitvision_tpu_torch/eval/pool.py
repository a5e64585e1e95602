"""The shared detector/segmenter/reader training pool: render, write, load.

Counterpart of the JAX package's `scripts/gen_pool.py` (`render_item`,
its write loop) and `scripts/train_detector.py:load_pool`, with PIL's
letterbox resize done by `ops/image.resize_pil_bilinear_u8`. Each item:

  image   (H, W, 3) uint8   glyph or hand-drawn schematic render
  mask    (H, W)    uint8   GT wire mask (0/255), warped with the image
  boxes   (N, 4)    int32   GT detections xyxy (incl. value-text boxes)
  classes (N,)      str     class names aligned with `boxes`
  values  (N,)      str     printed value per box ('' = none)
  dirs    (N,)      str     drawn polarity direction per box ('' = none)
  tier    str               degradation tier applied ('' = clean)

`handdrawn_frac` of the items are hand-drawn photo-style circuits, the
rest straight glyph renders; `degrade_frac` of all items get one random
degradation tier with the ground truth warped alike. Seeds start far
from the eval corpus's (below 10000), so the eval set is never trained
on.
"""
from __future__ import annotations

import glob
import json
import os
import time

import numpy as np

from ..core.types import BBox


def render_item(seed: int, handdrawn_frac: float = 0.25, degrade_frac: float = 0.40,
                timings: dict | None = None) -> dict:
    """One pool item from `seed` (scripts/gen_pool.py:render_item). With
    `timings`, adds the host seconds of the render under "schematic" or
    "handdrawn" and of the degradation under its tier's name."""
    from .degrade import DEGRADE_TIERS, degrade
    from .glyphs import render_schematic
    from .handdrawn import handdrawn_circuit
    from .randomized import random_circuit

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    if rng.random() < handdrawn_frac:
        # photo style: ink colors, paper tints, notebook ruling lines,
        # ladder and bridge layouts
        img, mask, boxes, values, dirs, tb = handdrawn_circuit(seed, style="photo")
        kind = "handdrawn"
    else:
        mask, boxes = random_circuit(seed)
        for b in boxes:
            b.semantic_direction = None
            b.semantic_reason = None
        img, values, dirs, tb = render_schematic(mask, boxes, rng)
        kind = "schematic"
    all_boxes = list(boxes) + list(tb)
    t1 = time.perf_counter()
    tier = ""
    if rng.random() < degrade_frac:
        tier = str(rng.choice(sorted(DEGRADE_TIERS)))
        img, all_boxes, mask = degrade(img, tier, seed, boxes=all_boxes, mask=mask)
    if timings is not None:
        timings.setdefault(kind, []).append(t1 - t0)
        if tier:
            timings.setdefault(tier, []).append(time.perf_counter() - t1)
    return {
        "image": np.asarray(img, np.uint8),
        "mask": np.asarray(mask, np.uint8),
        "boxes": np.asarray(
            [[b.xmin, b.ymin, b.xmax, b.ymax] for b in all_boxes], np.int32
        ).reshape(-1, 4),
        "classes": np.asarray([b.class_name for b in all_boxes]),
        "values": np.asarray([values.get(b.persistent_uid, "") or "" for b in all_boxes]),
        "dirs": np.asarray([dirs.get(b.persistent_uid, "") or "" for b in all_boxes]),
        "tier": tier,
    }


def write_pool(out: str, n: int, seed0: int = 100000, handdrawn_frac: float = 0.25,
               degrade_frac: float = 0.40, log_every: int = 200,
               timings: dict | None = None) -> None:
    """Render items seed0 .. seed0 + n − 1 into out/<i:06d>.npz
    (np.savez_compressed), skipping those already there (resumable), then
    out/pool_meta.json. `timings` as render_item's."""
    os.makedirs(out, exist_ok=True)
    t0 = time.time()
    for i in range(n):
        path = os.path.join(out, f"{i:06d}.npz")
        if os.path.exists(path):
            continue
        item = render_item(seed0 + i, handdrawn_frac, degrade_frac, timings)
        tmp = os.path.join(out, f"_partial_{i:06d}.npz")
        np.savez_compressed(tmp, **item)
        os.replace(tmp, path)
        if log_every and (i + 1) % log_every == 0:
            dt = time.time() - t0
            print(f"{i + 1}/{n} items ({dt:.0f}s, {dt / (i + 1) * 1e3:.0f} ms/item)", flush=True)
    with open(os.path.join(out, "pool_meta.json"), "w") as f:
        json.dump({"out": out, "n": n, "seed0": seed0, "handdrawn_frac": handdrawn_frac,
                   "degrade_frac": degrade_frac}, f, indent=1)


def letterbox_item(img: np.ndarray, boxes_xyxy, classes, img_size: int):
    """(img_size, img_size, 3) uint8 letterbox (gray 114 borders, PIL's
    bilinear resize) and the boxes mapped into it
    (scripts/train_detector.py:load_pool's per-item step)."""
    from ..ops.image import resize_pil_bilinear_u8

    out = np.full((img_size, img_size, 3), 114, np.uint8)
    h, w = img.shape[:2]
    s = min(img_size / h, img_size / w)
    nh, nw = int(round(h * s)), int(round(w * s))
    px, py = (img_size - nw) // 2, (img_size - nh) // 2
    out[py:py + nh, px:px + nw] = resize_pil_bilinear_u8(img, (nh, nw))
    boxes = [
        BBox(class_name=str(c), confidence=1.0,
             xmin=int(b[0] * s + px), ymin=int(b[1] * s + py),
             xmax=int(b[2] * s + px), ymax=int(b[3] * s + py))
        for b, c in zip(boxes_xyxy, classes)
    ]
    return out, boxes


def load_pool(pool_dir: str, img_size: int, limit: int = 0):
    """Letterbox every pool item once into RAM, cached in the pool
    directory so that a restart is instant.

    Returns (images (N, S, S, 3) uint8, boxes per image list[list[BBox]],
    tiers list[str])."""
    # pool items only: files starting with "_" are the trainers' caches
    files = sorted(f for f in glob.glob(os.path.join(pool_dir, "*.npz"))
                   if not os.path.basename(f).startswith("_"))
    files = files[:limit] if limit else files
    if not files:
        raise FileNotFoundError(f"no pool items under {pool_dir}")
    cache = os.path.join(pool_dir, f"_letterboxed_{img_size}_{len(files)}")
    if os.path.exists(cache + ".npy") and os.path.exists(cache + ".json"):
        images = np.load(cache + ".npy")
        with open(cache + ".json") as f:
            meta = json.load(f)
        boxes_all = [[BBox(class_name=c, confidence=1.0, xmin=b[0], ymin=b[1], xmax=b[2],
                           ymax=b[3]) for c, b in item] for item in meta["boxes"]]
        return images, boxes_all, meta["tiers"]
    images = np.empty((len(files), img_size, img_size, 3), np.uint8)
    boxes_all, tiers = [], []
    for i, f in enumerate(files):
        with np.load(f, allow_pickle=False) as z:
            images[i], boxes = letterbox_item(z["image"], z["boxes"], z["classes"], img_size)
            tiers.append(str(z["tier"]))
        boxes_all.append(boxes)
    np.save(cache + ".npy", images)
    with open(cache + ".json", "w") as f:
        json.dump({"tiers": tiers,
                   "boxes": [[(b.class_name, (b.xmin, b.ymin, b.xmax, b.ymax)) for b in bs]
                             for bs in boxes_all]}, f)
    return images, boxes_all, tiers
