"""The detector's trainer: target packing, the optimizer, the train step
and the training loop.

Counterpart of the JAX package's `train/yolo_train.py` and the loop of
`scripts/train_detector.py:174-280`. As in the JAX package, the step
differentiates and updates the whole variable tree: the parameters are
the model's whole state dict ({port name: tensor}, `bridge`'s names),
the BatchNorm statistics (`running_mean`, `running_var`, flax's
`batch_stats`) included, run through the model with
torch.func.functional_call. The convolutions' BatchNorm uses the running
statistics (flax `use_running_average=True`), the statistics take
gradients through it, and AdamW's decay acts on them too — which is what
the JAX trainer does, and so what the port does.

The trainer saves resumable state with `train/checkpoint.save_train_state`,
and `save_detector` the trained model as the JAX script's final orbax
model checkpoint, which the analyzer of either package loads.
"""
from __future__ import annotations

import logging
import math
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.taxonomy import ID_TO_NAME, TRAIN_CLASSES
from ..core.types import BBox
from . import optim
from .yolo_loss import YOLOLossConfig, yolo_detection_loss

log = logging.getLogger(__name__)


def targets_from_boxes(boxes_per_image: Sequence[Sequence[BBox]], max_gt: int = 64,
                       class_to_id: Optional[dict] = None):
    """Pad host BBox lists to static (B, M) tensors: (gt_boxes (B, M, 4)
    float32 xyxy, gt_classes (B, M) int32, gt_valid (B, M) bool), on the
    CPU. Boxes must be in the model's input pixels (letterboxed).

    Defaults to the trainable label space (taxonomy.TRAIN_CLASSES); a
    class name outside the map becomes id 0 (__background__), and boxes
    past max_gt are dropped: both are warned about."""
    class_to_id = class_to_id or dict(TRAIN_CLASSES)
    unmapped = {b.class_name for boxes in boxes_per_image for b in boxes
                if b.class_name not in class_to_id}
    if unmapped:
        log.warning(
            "targets_from_boxes: %d class name(s) not in the label map "
            "become __background__ GT (the model learns to ignore them): %s",
            len(unmapped), sorted(unmapped))
    B = len(boxes_per_image)
    dropped = sum(max(0, len(b) - max_gt) for b in boxes_per_image)
    if dropped:
        log.warning(
            "targets_from_boxes: dropping %d ground-truth boxes over "
            "max_gt=%d (max per image: %d) — raise max_gt",
            dropped, max_gt, max(len(b) for b in boxes_per_image))
    gt_boxes = np.zeros((B, max_gt, 4), np.float32)
    gt_classes = np.zeros((B, max_gt), np.int32)
    gt_valid = np.zeros((B, max_gt), bool)
    for i, boxes in enumerate(boxes_per_image):
        for j, b in enumerate(boxes[:max_gt]):
            gt_boxes[i, j] = (b.xmin, b.ymin, b.xmax, b.ymax)
            gt_classes[i, j] = class_to_id.get(b.class_name, 0)
            gt_valid[i, j] = True
    return torch.from_numpy(gt_boxes), torch.from_numpy(gt_classes), torch.from_numpy(gt_valid)


def init_detect_biases(params: dict, num_classes: int, img_size: int,
                       strides=(8, 16, 32)) -> dict:
    """Detect-head prior bias init for training from random weights
    (ultralytics Detect.bias_init): the class convs' biases start at
    log(5 / nc / (size / stride)²), the box convs' at 1.0. Returns a new
    dict; the others are the same tensors."""
    out = dict(params)
    for i, s in enumerate(strides):
        box = params[f"cv2_{i}_2.bias"]
        out[f"cv2_{i}_2.bias"] = torch.full_like(box, 1.0)
        cls = params[f"cv3_{i}_2.bias"]
        out[f"cv3_{i}_2.bias"] = torch.full_like(
            cls, math.log(5.0 / num_classes / (img_size / s) ** 2))
    return out


def make_yolo_optimizer(learning_rate: float = 1e-3, weight_decay: float = 5e-4,
                        warmup_steps: int = 0, total_steps: int = 0,
                        clip_norm: float = 10.0) -> optim.Transform:
    """Global-norm-clipped AdamW with an optional warmup (and cosine decay
    to 5 % when total_steps > 0), inside apply_if_finite(50): clipping
    does not stop a non-finite gradient, and one bad batch would poison
    every leaf."""
    lr: float | optim.Schedule = learning_rate
    if total_steps > 0:
        lr = optim.warmup_cosine_decay_schedule(
            0.0, learning_rate, warmup_steps=max(1, warmup_steps), decay_steps=total_steps,
            end_value=learning_rate * 0.05)
    elif warmup_steps > 0:
        lr = optim.join_schedules(
            [optim.linear_schedule(0.0, learning_rate, warmup_steps),
             optim.constant_schedule(learning_rate)],
            [warmup_steps])
    return optim.apply_if_finite(
        optim.chain(optim.clip_by_global_norm(clip_norm),
                    optim.adamw(lr, weight_decay=weight_decay)),
        max_consecutive_errors=50)


def yolo_params(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The whole variable tree of `model`: its state dict, detached."""
    return {n: t.detach() for n, t in model.state_dict().items()}


def yolo_loss_and_grads(model, params, images, gt_boxes, gt_classes, gt_valid,
                        cfg: YOLOLossConfig):
    """(metrics, grads) of the detection loss, every leaf of `params`
    differentiated."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    outs = torch.func.functional_call(model, leaves, (images,))
    loss, metrics = yolo_detection_loss(outs, gt_boxes, gt_classes, gt_valid, cfg)
    names = list(leaves)
    got = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
    grads = {n: g if g is not None else torch.zeros_like(leaves[n]) for n, g in zip(names, got)}
    return {k: v.detach() for k, v in metrics.items()}, grads


def make_yolo_train_step(model: torch.nn.Module, tx: optim.Transform, cfg: YOLOLossConfig):
    """train_step(params, opt_state, images, gt_boxes, gt_classes,
    gt_valid) → (params, opt_state, metrics); images (B, S, S, 3) in
    [0, 1] on the model's device."""
    def train_step(params, opt_state, images, gt_boxes, gt_classes, gt_valid):
        metrics, grads = yolo_loss_and_grads(model, params, images, gt_boxes, gt_classes,
                                             gt_valid, cfg)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optim.apply_updates(params, updates), opt_state, metrics

    return train_step


@torch.no_grad()
def eval_map50(model, params, det_cfg, images_u8: torch.Tensor, gt_boxes_lists,
               batch: int = 16) -> dict:
    """mAP@50 through the serving decode (DFL + NMS) at ultralytics' val
    thresholds (conf 0.001, IoU 0.7, 256 detections), on (N, S, S, 3)
    uint8 images on the model's device (scripts/train_yolo_demo.py:eval_map50)."""
    from ..eval.metrics import map50
    from ..models.yolo.decode import decode_predictions, postprocess

    preds = []
    for s in range(0, images_u8.shape[0], batch):
        x = images_u8[s:s + batch].float() / 255.0
        outs = torch.func.functional_call(model, params, (x,))
        boxes, scores = decode_predictions(outs, det_cfg.reg_max, det_cfg.num_classes)
        for i in range(x.shape[0]):
            bxs, scs, cls, keep = postprocess(boxes[i], scores[i], max_detections=256,
                                              conf_threshold=0.001, iou_threshold=0.7)
            keep = keep.cpu().numpy().astype(bool)
            bxs, scs, cls = bxs.cpu().numpy()[keep], scs.cpu().numpy()[keep], cls.cpu().numpy()[keep]
            preds.append([BBox(class_name=ID_TO_NAME.get(int(c), str(int(c))), confidence=float(p),
                               xmin=int(b[0]), ymin=int(b[1]), xmax=int(b[2]), ymax=int(b[3]))
                          for b, p, c in zip(bxs, scs, cls)])
    return map50(preds, gt_boxes_lists)


def train_detector(images: np.ndarray, boxes_all, tiers, *, scale: str = "s",
                   img_size: int = 640, steps: int = 12000, batch: int = 16, lr: float = 2e-3,
                   warmup_steps: int = 200, max_gt: int = 96, val_n: int = 96,
                   log_every: int = 100, eval_every: int = 2000, ckpt_dir: Optional[str] = None,
                   save_every: int = 1000, device="cuda", seed: int = 0,
                   report: Callable[[str], None] = print) -> dict:
    """The loop of scripts/train_detector.py on a letterboxed pool
    (`eval/pool.load_pool`'s output): YOLOv11-<scale> from random weights
    (seeded), `init_detect_biases`, the pool resident on the device as
    uint8 with batches gathered there by index, resume from `ckpt_dir`,
    logged losses, held-out mAP@50 (all, clean, degraded) at the start,
    every `eval_every` steps and at the end, and an abort when the run
    collapses to loss 0 with no foreground anchors.

    Returns {"params", "opt_state", "history": [per logged step: step,
    loss, box, cls, dfl, fg, skipped, seconds], "map": {tag: mAP@50}}."""
    from ..core.config import DetectorConfig, resolve_device
    from ..models.yolo.model import YOLOv11
    from .checkpoint import (latest_checkpoint, prune_checkpoints, restore_train_state,
                             save_train_state)

    dev = resolve_device(device, "train_detector")
    det_cfg = DetectorConfig(scale=scale, img_size=img_size, num_classes=len(TRAIN_CLASSES))
    n_val = min(val_n, len(images) // 4)
    n_train = len(images) - n_val
    report(f"pool: {n_train} train + {n_val} val images ({sum(1 for t in tiers if t)} degraded)")
    gb, gc, gv = (t.to(dev) for t in targets_from_boxes(boxes_all, max_gt=max_gt))

    torch.manual_seed(seed)
    model = YOLOv11(num_classes=det_cfg.num_classes, scale=scale, reg_max=det_cfg.reg_max)
    model.to(dev)
    params = init_detect_biases(yolo_params(model), det_cfg.num_classes, img_size)
    n_params = sum(p.numel() for p in params.values())
    report(f"YOLOv11-{scale}@{img_size}: {n_params:,} params, {steps} steps x batch {batch}")

    loss_cfg = YOLOLossConfig(num_classes=det_cfg.num_classes, reg_max=det_cfg.reg_max,
                              img_size=img_size)
    tx = make_yolo_optimizer(lr, warmup_steps=warmup_steps, total_steps=steps)
    opt = tx.init(params)
    start = 0
    found = latest_checkpoint(ckpt_dir) if ckpt_dir else None
    if found:
        start = found[0]
        params, opt = restore_train_state(found[1], params, opt)
        report(f"resumed from {found[1]} (step {start})")

    images_dev = torch.as_tensor(np.ascontiguousarray(images), device=dev)
    step = make_yolo_train_step(model, tx, loss_cfg)
    val_gt, val_tiers = boxes_all[n_train:], tiers[n_train:]
    maps: dict = {}

    def run_eval(tag: str):
        val = images_dev[n_train:]
        parts = {"all": eval_map50(model, params, det_cfg, val, val_gt)["map"]}
        for name, idx in (("clean", [i for i, t in enumerate(val_tiers) if not t]),
                          ("degraded", [i for i, t in enumerate(val_tiers) if t])):
            if idx:
                parts[name] = eval_map50(model, params, det_cfg, val[idx],
                                         [val_gt[i] for i in idx])["map"]
        report(f"[{tag}] held-out mAP@50: " + "  ".join(f"{k} {v:.4f}" for k, v in parts.items()))
        maps[tag] = parts

    run_eval(f"step {start}")
    rng = np.random.default_rng(1234 + start)
    history = []
    t0 = time.time()
    for i in range(start, steps):
        sel = torch.as_tensor(rng.integers(0, n_train, batch), device=dev)
        x = images_dev[sel].float() / 255.0
        params, opt, metrics = step(params, opt, x, gb[sel], gc[sel], gv[sel])
        if i % log_every == 0 or i == steps - 1:
            row = {"step": i, "loss": float(metrics["loss"]),
                   "box": float(metrics["box_loss"]), "cls": float(metrics["cls_loss"]),
                   "dfl": float(metrics["dfl_loss"]), "fg": int(metrics["n_fg"]),
                   "skipped": int(opt["notfinite_count"]), "seconds": time.time() - t0}
            history.append(row)
            report(f"step {i:5d}  loss {row['loss']:.4f}  box {row['box']:.3f}  "
                   f"cls {row['cls']:.3f}  dfl {row['dfl']:.3f}  fg {row['fg']}  "
                   f"skipped {row['skipped']}  ({row['seconds']:.0f}s)")
            if row["loss"] == 0.0 and row["fg"] == 0:
                raise RuntimeError("collapsed run (loss 0, fg 0 — poisoned params); "
                                   "aborting instead of burning the remaining steps")
        if eval_every and i and i % eval_every == 0:
            run_eval(f"step {i}")
        if ckpt_dir and ((i + 1) % save_every == 0 or i == steps - 1):
            save_train_state(ckpt_dir, i + 1, params, opt)
            prune_checkpoints(ckpt_dir, keep=2)
    run_eval("final")
    return {"params": params, "opt_state": opt, "history": history, "map": maps,
            "model": model}


def save_detector(path: str, out: dict, *, scale: str, img_size: int, steps: int, batch: int,
                  pool: str) -> None:
    """`train_detector`'s result `out` as the JAX trainer saves its model
    (scripts/train_detector.py:258-279): the variable tree through
    `bridge.variables_from_state_dict` and save_model_checkpoint, with
    the meta "kind", "detector" (scale, img_size, num_classes, reg_max)
    and "train" (steps, batch, the pool's name, the final held-out
    mAP@50)."""
    from ..models.bridge import variables_from_state_dict
    from ..models.checkpoint_writer import save_model_checkpoint

    model = out["model"]
    save_model_checkpoint(path, variables_from_state_dict(out["params"], model), meta={
        "kind": "yolo",
        "detector": {"scale": scale, "img_size": img_size, "num_classes": model.num_classes,
                     "reg_max": model.reg_max},
        "train": {"steps": steps, "batch": batch, "pool": pool,
                  "map50_holdout": float(out["map"]["final"]["all"])},
    })
