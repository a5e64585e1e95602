"""End-to-end evaluation of the PyTorch port: scripts/eval_pipeline.py
over `circuitvision_tpu_torch`.

Scores the pipeline against an eval set with the three acceptance
metrics of BASELINE.md — detection mAP@50, segmentation pixel accuracy
(and mean IoU), netlist text exact match — over the port's
`eval/metrics.py`, `eval/degrade.py` and `io/image_io` (ground-truth
masks read by the port's PNG reader). The flags, the modes and the
report JSON are the JAX script's:

    images/<name>.(png|jpg)   netlists/<name>.cir   boxes/<name>.json
    masks/<name>.png          labels/<name>.json (canned VLM output)

  * default: the full model (give --yolo-checkpoint and
    --sam2-checkpoint for meaningful numbers; without a YOLO checkpoint
    the detector gets seeded random weights at --scale and --det-size,
    as the port's CLI gives it);
  * --oracle-boxes: the ground-truth boxes as the detections;
  * --classical-mask: the adaptive-threshold mask instead of SAM2;
  * --degrade TIER (eval/degrade.py), or `all` for the clean set plus a
    `degraded` section per tier;
  * a labels/<name>.json primes a FakeVLMClient per image (its
    directions and values) and adds the final value-merged netlist;
    --vlm reader:<dir> reads them with the trained crop reader instead.

The analyzer runs on --device (default cuda; cpu on request). A SAM2
checkpoint runs in float32, as the JAX script runs it.

Usage:
    python scripts/torch_eval_pipeline.py --data eval_data/ --oracle-boxes \\
        --classical-mask --device cpu
    python scripts/torch_eval_pipeline.py --data eval_data/ \\
        --yolo-checkpoint ckpt/yolo --sam2-checkpoint ckpt/sam2
"""
from __future__ import annotations

import argparse
import copy
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

#: seed of the random detector weights used without a YOLO checkpoint
SEED = 0


def grey_mask(arr: np.ndarray) -> np.ndarray:
    """A mask PNG's samples as PIL's convert("L") gives them: grey as
    stored; RGB(A) as ITU-R 601 luma, (19595 R + 38470 G + 7471 B +
    2^15) >> 16."""
    if arr.ndim == 2:
        return arr
    rgb = arr[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def load_models(args):
    """(PipelineConfig, YOLO state, SAM2 state or None) as the JAX script
    configures its analyzer: a checkpoint's meta gives the detector and
    the SAM2 preset (in float32)."""
    from circuitvision_tpu_torch.core.config import DetectorConfig, PipelineConfig, SAM2Config
    from circuitvision_tpu_torch.models import bridge
    from circuitvision_tpu_torch.models.checkpoint import load_model_checkpoint

    det = DetectorConfig(scale=args.scale, img_size=args.det_size)
    ystate = None
    if args.yolo_checkpoint:
        yv, ymeta = load_model_checkpoint(args.yolo_checkpoint)
        ystate = bridge.state_dict_from_variables(yv)
        if "detector" in ymeta:
            det = bridge.detector_config(ymeta)
            print(f"yolo checkpoint meta: {ymeta['detector']}")
    if ystate is None:
        ystate = bridge.seeded_state("yolo", {"detector": {
            "scale": det.scale, "img_size": det.img_size, "num_classes": det.num_classes,
            "reg_max": det.reg_max}}, SEED)
    sam2_cfg, sstate = SAM2Config(), None
    if args.sam2_checkpoint:
        sv, smeta = load_model_checkpoint(args.sam2_checkpoint)
        sstate = bridge.state_dict_from_variables(sv)
        if "sam2" in smeta:
            sam2_cfg = bridge.sam2_config(smeta, dtype="float32")
            print(f"sam2 checkpoint meta: {smeta['sam2']}")
    use_sam2 = sstate is not None and not args.classical_mask
    cfg = PipelineConfig(detector=det, sam2=sam2_cfg, use_sam2=use_sam2)
    return cfg, ystate, sstate if use_sam2 else None


def run_eval(args, degrade_tier: str = None, models=None) -> dict:
    """The report of one pass over the eval set (the JAX script's
    run_eval), on a new analyzer of `models` (load_models' result, read
    here when not given)."""
    import zlib

    from circuitvision_tpu_torch.core.types import BBox
    from circuitvision_tpu_torch.enrich.client import FakeVLMClient
    from circuitvision_tpu_torch.eval.degrade import degrade
    from circuitvision_tpu_torch.eval.metrics import (
        map50, mask_accuracy, mask_iou, netlist_exact_match,
    )
    from circuitvision_tpu_torch.io.image_io import load_image, read_png
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch

    cfg, ystate, sstate = models or load_models(args)
    analyzer = CircuitAnalyzerTorch(cfg, ystate, sstate, device=args.device)
    reader_client = None
    if args.vlm:
        if not args.vlm.startswith("reader:"):
            raise SystemExit(f"--vlm expects reader:<ckpt>, got {args.vlm}")
        from circuitvision_tpu_torch.enrich.trained_reader import load_trained_reader

        reader_client = load_trained_reader(args.vlm.split(":", 1)[1], device=args.device)
        analyzer.vlm_client = reader_client

    image_paths = sorted(glob.glob(os.path.join(args.data, "images", "*.png"))
                         + glob.glob(os.path.join(args.data, "images", "*.jpg")))
    if args.limit:
        image_paths = image_paths[: args.limit]
    if not image_paths:
        raise FileNotFoundError(f"no images under {args.data}/images")

    categories = {}
    cat_path = os.path.join(args.data, "categories.json")
    if os.path.exists(cat_path):
        with open(cat_path) as f:
            categories = json.load(f)

    pred_boxes, gt_boxes = [], []
    pred_netlists, ref_netlists, netlist_names = [], [], []
    ious, accs = [], []

    for path in image_paths:
        name = os.path.splitext(os.path.basename(path))[0]
        image = load_image(path)

        gt = None
        gt_box_path = os.path.join(args.data, "boxes", f"{name}.json")
        if os.path.exists(gt_box_path):
            with open(gt_box_path) as f:
                gt = [BBox.from_dict(d) for d in json.load(f)]

        gt_mask_loaded = None
        gt_mask_path = os.path.join(args.data, "masks", f"{name}.png")
        if os.path.exists(gt_mask_path):
            gt_mask_loaded = grey_mask(read_png(gt_mask_path))

        if degrade_tier:
            # the JAX script's per-image corruption; geometric tiers warp
            # the ground-truth boxes and mask with the pixels
            image, gt, gt_mask_loaded = degrade(image, degrade_tier,
                                                seed=zlib.crc32(name.encode()),
                                                boxes=gt, mask=gt_mask_loaded)

        if args.oracle_boxes:
            if gt is None:
                raise FileNotFoundError(f"--oracle-boxes needs boxes/{name}.json")
            analyzer.bboxes = lambda img, gt=gt: copy.deepcopy(gt)

        label_path = os.path.join(args.data, "labels", f"{name}.json")
        if os.path.exists(label_path) and reader_client is None:
            with open(label_path) as f:
                canned = json.load(f)
            analyzer.vlm_client = FakeVLMClient(
                labels=canned.get("labels"),
                directions={k: tuple(v) for k, v in canned.get("directions", {}).items()})

        result = analyzer.analyze(image)
        if os.path.exists(label_path) or reader_client is not None:
            result = analyzer.generate_final_netlist(result)

        if gt is not None and not args.oracle_boxes:
            pred_boxes.append(result.bboxes_orig_nms)
            gt_boxes.append(gt)

        ref_net_path = os.path.join(args.data, "netlists", f"{name}.cir")
        if os.path.exists(ref_net_path):
            with open(ref_net_path) as f:
                ref_netlists.append(f.read())
            pred_netlists.append(result.netlist_text or "")
            netlist_names.append(name)

        if gt_mask_loaded is not None and result.sam_mask is not None:
            gt_mask = gt_mask_loaded
            if not gt_mask.any():
                gt_mask = None  # no wire: IoU undefined
            pred_mask = result.sam_mask if gt_mask is not None else None
        else:
            gt_mask = pred_mask = None
        if gt_mask is not None and pred_mask is not None:
            if pred_mask.shape != gt_mask.shape:
                # the mask is the crop's: back into the image's frame
                info = result.crop_info
                full = np.zeros(gt_mask.shape, np.uint8)
                if info is not None and info.applied and info.window:
                    x0, y0, x1, y1 = info.window
                    full[y0:y1, x0:x1] = pred_mask
                pred_mask = full
            ious.append(mask_iou(pred_mask, gt_mask))
            accs.append(mask_accuracy(pred_mask, gt_mask))

        print(f"{name}: {len(result.bboxes_orig_nms)} detections, {len(result.nodes)} nodes")

    report = {"images": len(image_paths)}
    if gt_boxes:
        report["detection"] = map50(pred_boxes, gt_boxes)
    if ious:
        report["segmentation"] = {"mean_iou": float(np.mean(ious)),
                                  "pixel_accuracy": float(np.mean(accs))}
    if ref_netlists:
        report["netlist_exact_match"] = netlist_exact_match(pred_netlists, ref_netlists)
        by_cat: dict = {}
        for name, pred, ref in zip(netlist_names, pred_netlists, ref_netlists):
            cat = categories.get(name, "basic")
            ok, total = by_cat.get(cat, (0, 0))
            by_cat[cat] = (ok + int(pred == ref), total + 1)
        report["netlist_exact_match_by_category"] = {
            cat: {"match": ok / total, "n": total} for cat, (ok, total) in sorted(by_cat.items())}
    return report


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True)
    p.add_argument("--yolo-checkpoint")
    p.add_argument("--sam2-checkpoint")
    p.add_argument("--scale", default="l", choices=list("nsmlx"))
    p.add_argument("--det-size", type=int, default=640)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--oracle-boxes", action="store_true")
    p.add_argument("--classical-mask", action="store_true")
    p.add_argument("--degrade", default=None,
                   help="corruption tier (eval/degrade.py: blur, shadow, jpeg, perspective, "
                        "wobble), or 'all' to score the clean set plus every tier and emit a "
                        "'degraded' report section")
    p.add_argument("--vlm", default=None,
                   help="reader:<ckpt> — read values/directions from pixels with the trained "
                        "crop reader instead of replaying canned VLM labels")
    p.add_argument("--out", default=None, help="also write the JSON report to this path")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def evaluate(args) -> dict:
    """The script's report: one pass, or with --degrade all the clean
    pass plus every tier's numbers, the checkpoints read once."""
    models = load_models(args)
    if args.degrade != "all":
        return run_eval(args, degrade_tier=args.degrade, models=models)
    from circuitvision_tpu_torch.eval.degrade import DEGRADE_TIERS

    report = run_eval(args, models=models)
    report["degraded"] = {}
    for tier in sorted(DEGRADE_TIERS):
        tier_report = run_eval(args, degrade_tier=tier, models=models)
        report["degraded"][tier] = {
            k: tier_report[k]
            for k in ("netlist_exact_match", "netlist_exact_match_by_category", "segmentation")
            if k in tier_report}
    return report


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    report = evaluate(args)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
