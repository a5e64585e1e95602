"""The crop reader's trainer: loss, train step, dataset and training loop.

Counterpart of the training half of the JAX package's `train/reader.py`
(`reader_loss`, `make_reader_train_step`, `generate_reader_dataset`) and
of `scripts/train_reader_demo.py` (`evaluate_product`, the loop), over
the port's `models/reader.CropReader`, `make_crop` (cv2-exact resize)
and `make_value_window`. Parameters are the reader's state dict
({port name: tensor}); the optimizer is `train/optim.adamw` with optax's
warmup-cosine schedule. `save_reader` writes the trained reader as the
JAX script does: a bare orbax checkpoint of its variable tree.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core import taxonomy
from ..models.reader import (DIRECTIONS, READER_CLASS_TO_ID, CropReader, ReaderConfig,
                             encode_value, make_crop, make_value_window)
from . import optim


def _ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def reader_loss(model: CropReader, params, crops, cls_ids, val_codes, dir_ids, val_w=None):
    """Cross-entropy over the three heads, the value head weighted 2;
    `val_w` ((B,) weights) masks the value loss of crops whose printed
    value is out of frame. crops (B, S, S, 3) uint8."""
    heads = torch.func.functional_call(model, params, (crops,))
    return heads_loss(heads, cls_ids, val_codes, dir_ids, val_w)


def heads_loss(heads, cls_ids, val_codes, dir_ids, val_w=None):
    """`reader_loss` from the reader's (class, value, direction) logits."""
    cls_logits, val_logits, dir_logits = heads
    cls_loss = _ce(cls_logits, cls_ids).mean()
    val_ce = _ce(val_logits, val_codes).mean(dim=-1)
    if val_w is None:
        val_loss = val_ce.mean()
    else:
        val_loss = (val_ce * val_w).sum() / torch.clamp(val_w.sum(), min=1.0)
    dir_loss = _ce(dir_logits, dir_ids).mean()
    total = cls_loss + 2.0 * val_loss + dir_loss
    return total, {"loss": total, "cls_loss": cls_loss, "val_loss": val_loss,
                   "dir_loss": dir_loss}


def reader_params(model: CropReader) -> dict[str, torch.Tensor]:
    return {n: t.detach() for n, t in model.state_dict().items()}


def reader_loss_and_grads(model, params, crops, cls_ids, val_codes, dir_ids, val_w=None):
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    loss, metrics = reader_loss(model, leaves, crops, cls_ids, val_codes, dir_ids, val_w)
    names = list(leaves)
    grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n] for n in names])))
    return {k: v.detach() for k, v in metrics.items()}, grads


def make_reader_train_step(model: CropReader, tx: optim.Transform):
    """step(params, opt_state, crops, cls_ids, val_codes, dir_ids,
    val_w=None) → (params, opt_state, metrics)."""
    def step(params, opt_state, crops, cls_ids, val_codes, dir_ids, val_w=None):
        metrics, grads = reader_loss_and_grads(model, params, crops, cls_ids, val_codes,
                                               dir_ids, val_w)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optim.apply_updates(params, updates), opt_state, metrics

    return step


def generate_reader_dataset(n_circuits: int, seed0: int) -> dict:
    """Render n_circuits random schematics with glyphs and printed values
    and cut the training crops: per component two native value windows
    (centred, and jittered), and for a directional component a
    serving-geometry direction crop (pad 15) whose value loss is masked.

    Returns numpy arrays: crops (N, S, S, 3) uint8, cls (N,) int32,
    val (N, 8) int32, dir (N,) int32, val_w (N,) float32."""
    from ..eval.glyphs import render_schematic
    from ..eval.randomized import random_circuit

    crops, cls_ids, val_codes, dir_ids, val_w = [], [], [], [], []
    unk = READER_CLASS_TO_ID.get("unknown", 0)
    for i in range(n_circuits):
        mask, boxes = random_circuit(seed0 + i)
        rng = np.random.default_rng(seed0 + i)
        img, values, dirs, _tb = render_schematic(mask, boxes, rng)
        for b in boxes:
            if b.class_name in taxonomy.NETLIST_IGNORE_CLASSES or b.class_name == "circuit":
                continue
            d = dirs.get(b.persistent_uid)
            d_id = DIRECTIONS.index(d) if d in DIRECTIONS else 0
            cid = READER_CLASS_TO_ID.get(b.class_name, unk)
            vcode = encode_value(values.get(b.persistent_uid))
            for jitter in ((0, 0), tuple(rng.integers(-8, 9, size=2))):
                crops.append(make_value_window(img, b, jitter=jitter))
                cls_ids.append(cid)
                val_codes.append(vcode)
                dir_ids.append(d_id)
                val_w.append(1.0)
            if d_id != 0:
                crops.append(make_crop(img, b, pad=15))
                cls_ids.append(cid)
                val_codes.append(encode_value(None))
                dir_ids.append(d_id)
                val_w.append(0.0)
    return {
        "crops": np.stack(crops).astype(np.uint8),
        "cls": np.asarray(cls_ids, np.int32),
        "val": np.stack(val_codes).astype(np.int32),
        "dir": np.asarray(dir_ids, np.int32),
        "val_w": np.asarray(val_w, np.float32),
    }


def evaluate_product(params, val_circuits: int, seed0: int, device="cuda",
                     cfg: Optional[ReaderConfig] = None) -> dict:
    """Held-out product metrics through the serving client
    (`enrich/trained_reader.TrainedReaderClient`): exact match of the
    {id, class, value} rows and of whole images, and direction accuracy
    on the serving crops (scripts/train_reader_demo.py:evaluate_product);
    beside them each head's own accuracy on the rows, `class_accuracy`
    and `value_accuracy`."""
    from ..enrich.trained_reader import TrainedReaderClient
    from ..eval.glyphs import render_schematic
    from ..eval.randomized import random_circuit

    client = TrainedReaderClient({n: p.detach() for n, p in params.items()}, cfg, device=device)
    n_rows = n_rows_ok = n_imgs = n_imgs_ok = n_dirs = n_dirs_ok = n_cls_ok = n_val_ok = 0
    for i in range(val_circuits):
        mask, boxes = random_circuit(seed0 + i)
        rng = np.random.default_rng(seed0 + i)
        img, values, dirs, _tb = render_schematic(mask, boxes, rng)
        enum_boxes, gt_rows = [], []
        vid = 1
        for b in boxes:
            if b.class_name in taxonomy.NETLIST_IGNORE_CLASSES or b.class_name == "circuit":
                continue
            enum_boxes.append(dataclasses.replace(b, visual_id=vid))
            gt_rows.append({"id": str(vid), "class": b.class_name,
                            "value": values.get(b.persistent_uid)})
            vid += 1
        out = client.get_labels_batch_boxes([img], [enum_boxes])[0]
        by_id = {r["id"]: r for r in out}
        img_ok = True
        for gt in gt_rows:
            got = by_id.get(gt["id"])
            cls_ok = got is not None and got["class"] == gt["class"]
            val_ok = got is not None and got["value"] == gt["value"]
            ok = cls_ok and val_ok
            n_cls_ok += int(cls_ok)
            n_val_ok += int(val_ok)
            n_rows += 1
            n_rows_ok += int(ok)
            img_ok &= ok
        n_imgs += 1
        n_imgs_ok += int(img_ok)
        djobs = [(b, dirs[b.persistent_uid]) for b in boxes if b.persistent_uid in dirs]
        if djobs:
            answers = client.get_directions_batch([make_crop(img, b, pad=15) for b, _ in djobs],
                                                  [b.class_name for b, _ in djobs])
            for (_, want), (got, _reason) in zip(djobs, answers):
                n_dirs += 1
                n_dirs_ok += int(got == want)
    return {
        "row_exact_match": n_rows_ok / max(1, n_rows),
        "image_exact_match": n_imgs_ok / max(1, n_imgs),
        "rows": n_rows,
        "direction_accuracy": n_dirs_ok / max(1, n_dirs),
        "direction_reads": n_dirs,
        "class_accuracy": n_cls_ok / max(1, n_rows),
        "value_accuracy": n_val_ok / max(1, n_rows),
    }


def make_reader_optimizer(lr: float, steps: int) -> optim.Transform:
    """adamw(warmup 10 % → cosine to 5 %, weight decay 1e-4), the JAX
    reader demo's optimizer."""
    sched = optim.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=max(1, steps // 10),
                                               decay_steps=steps, end_value=lr * 0.05)
    return optim.adamw(sched, weight_decay=1e-4)


def train_reader(data: dict, *, steps: int = 4000, batch: int = 256, lr: float = 3e-4,
                 log_every: int = 100, device="cuda", seed: int = 0,
                 cfg: Optional[ReaderConfig] = None,
                 report: Callable[[str], None] = print) -> dict:
    """The loop of scripts/train_reader_demo.py on a `generate_reader_dataset`
    dict: the reader from random weights (seeded), the dataset resident on
    the device with batches gathered there by index. Returns {"params",
    "opt_state", "history": [per logged step: step, loss, cls, val, dir,
    seconds]}."""
    from ..core.config import resolve_device

    dev = resolve_device(device, "train_reader")
    cfg = cfg or ReaderConfig()
    torch.manual_seed(seed)
    model = CropReader(cfg).to(dev)
    params = reader_params(model)
    report(f"reader: {sum(p.numel() for p in params.values()):,} params, {steps} steps x "
           f"batch {batch}")
    tx = make_reader_optimizer(lr, steps)
    opt = tx.init(params)
    step = make_reader_train_step(model, tx)
    data_dev = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev) for k, v in data.items()}
    n = data_dev["crops"].shape[0]
    rng = np.random.default_rng(0)
    history = []
    t0 = time.time()
    for i in range(steps):
        sel = torch.as_tensor(rng.integers(0, n, batch), device=dev)
        params, opt, metrics = step(params, opt, data_dev["crops"][sel], data_dev["cls"][sel],
                                    data_dev["val"][sel], data_dev["dir"][sel],
                                    data_dev["val_w"][sel])
        if i % log_every == 0 or i == steps - 1:
            row = {"step": i, "loss": float(metrics["loss"]), "cls": float(metrics["cls_loss"]),
                   "val": float(metrics["val_loss"]), "dir": float(metrics["dir_loss"]),
                   "seconds": time.time() - t0}
            history.append(row)
            report(f"step {i:5d}  loss {row['loss']:.4f}  cls {row['cls']:.3f}  "
                   f"val {row['val']:.3f}  dir {row['dir']:.3f}  ({row['seconds']:.1f}s)")
    return {"params": params, "opt_state": opt, "history": history, "model": model}


def save_reader(path: str, out: dict) -> None:
    """`train_reader`'s result `out` as scripts/train_reader_demo.py:191-194
    saves the reader: its variable tree {"params": ...}
    (`bridge.variables_from_state_dict`) as a bare orbax checkpoint,
    which `enrich/trained_reader` of either package loads."""
    from ..models.bridge import variables_from_state_dict
    from ..models.checkpoint_writer import save_variables

    save_variables(path, variables_from_state_dict(out["params"], out["model"]))
