#!/usr/bin/env python3
"""How closely the PyTorch port follows the JAX package on the CPU: the
numbers behind the port's parity tests, printed as JSON lines.

    JAX_PLATFORMS=cpu python scripts/port_parity_cpu.py

  * `shipped_f32`: ckpt/yolo + ckpt/sam2 in float32 on both sides (JAX at
    "highest" matmul precision), per eval image (golden, loop, ac_rc):
    SAM2 mask pixels that differ, and the largest |logit| difference of
    the two logit maps at the analysed image's resolution;
  * `shipped_bf16`: the same checkpoints in bfloat16 on both sides: the
    boxes that differ after NMS, node counts, netlist equality, mask
    agreement;
  * `l1024_cut`: SAM2.1 Hiera-L@1024 with the depth cut to stages
    (1, 1, 3, 2) and global block 4, JAX-initialised weights carried
    through the bridge, float32: the largest |logit| difference.

An offline tool: it imports the JAX package (the port never does).
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(REPO))
    import cv2
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from circuitvision_tpu.core.config import DetectorConfig as JDet
    from circuitvision_tpu.core.config import PipelineConfig as JPipe
    from circuitvision_tpu.core.config import SAM2Config as JSAM2Config
    from circuitvision_tpu.core.config import sam2_hiera_preset
    from circuitvision_tpu.models.checkpoint import load_model_checkpoint
    from circuitvision_tpu.models.sam2.wrapper import SAM2ImageSegmenter as JSAM2
    from circuitvision_tpu.models.sam2.wrapper import init_params
    from circuitvision_tpu.ops.image import sam2_preprocess
    from circuitvision_tpu.pipeline.analyzer import CircuitAnalyzerTPU
    from circuitvision_tpu_torch.core import config as tconfig
    from circuitvision_tpu_torch.models import bridge
    from circuitvision_tpu_torch.models.sam2.wrapper import SAM2ImageSegmenter as TSAM2
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch

    jax.config.update("jax_default_matmul_precision", "highest")
    yv, ymeta = load_model_checkpoint(str(REPO / "ckpt" / "yolo"))
    sv, smeta = load_model_checkpoint(str(REPO / "ckpt" / "sam2"))
    yv, sv = jax.tree.map(np.asarray, yv), jax.tree.map(np.asarray, sv)
    ys, ss = bridge.state_dict_from_variables(yv), bridge.state_dict_from_variables(sv)
    d, s = ymeta["detector"], smeta["sam2"]
    images = {n: cv2.cvtColor(cv2.imread(str(REPO / "eval_data" / "images" / f"{n}.png")),
                              cv2.COLOR_BGR2RGB) for n in ("golden", "loop", "ac_rc")}

    def pair(dtype):
        jcfg = JPipe(detector=JDet(scale=d["scale"], img_size=d["img_size"],
                                   num_classes=d["num_classes"], reg_max=d["reg_max"],
                                   dtype=dtype),
                     sam2=sam2_hiera_preset(s["preset"], dtype=dtype, **s["overrides"]))
        tcfg = tconfig.PipelineConfig(
            detector=dataclasses.replace(bridge.detector_config(ymeta), dtype=dtype),
            sam2=bridge.sam2_config(smeta, dtype=dtype))
        ja = CircuitAnalyzerTPU(config=jcfg, yolo_variables=yv, sam2_variables=sv,
                                vlm_client=None)
        ja.vlm_client = None
        return ja, CircuitAnalyzerTorch(tcfg, ys, ss, device="cpu")

    ja, ta = pair("float32")
    for name, img in images.items():
        ref, got = ja.analyze(img), ta.analyze(img)
        crop = got.image_for_analysis
        h, w = crop.shape[:2]
        x = sam2_preprocess(jnp.asarray(crop), ja.cfg.sam2.resolution)[None]
        jl = jax.image.resize(ja._jit_segment_core(ja.sam2_variables, x)[0], (1, h, w),
                              method="linear", antialias=False)[0]
        tl = ta.segment_logits(crop).numpy()
        print(json.dumps({"shipped_f32": name, "pixels": int(got.sam_mask.size),
                          "mask_pixels_differing": int((got.sam_mask != ref.sam_mask).sum()),
                          "max_logit_diff": float(np.abs(tl - np.asarray(jl)).max()),
                          "max_abs_logit": float(np.abs(tl).max())}), flush=True)

    ja, ta = pair("bfloat16")
    for name, img in images.items():
        ref, got = ja.analyze(img), ta.analyze(img)
        box = lambda r: [(b.class_name, b.xmin, b.ymin, b.xmax, b.ymax,  # noqa: E731
                          round(b.confidence, 4)) for b in r.bboxes_orig_nms]
        diffs = [(a, b) for a, b in zip(box(ref), box(got)) if a[:5] != b[:5]]
        print(json.dumps({"shipped_bf16": name, "boxes": [len(ref.bboxes_orig_nms),
                                                          len(got.bboxes_orig_nms)],
                          "boxes_differing_jax_port": diffs,
                          "nodes": [len(ref.nodes), len(got.nodes)],
                          "netlist_equal": got.netlist_text == ref.netlist_text,
                          "mask_agreement": float(np.mean(got.sam_mask == ref.sam_mask))}),
              flush=True)

    cut = dict(stages=(1, 1, 3, 2), global_att_blocks=(4,), dtype="float32")
    jm = JSAM2(cfg=JSAM2Config(**cut))
    v = jax.tree.map(np.asarray, init_params(jm, jax.random.PRNGKey(1)))
    tm = TSAM2(tconfig.SAM2Config(**cut))
    tm.load_state_dict(bridge.state_dict_from_variables(v), strict=True)
    x = np.random.default_rng(5).standard_normal((1, 1024, 1024, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x))[0])
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))[0].numpy()
    print(json.dumps({"l1024_cut": list(cut["stages"]), "max_logit_diff":
                      float(np.abs(got - ref).max()), "max_abs_logit": float(np.abs(ref).max())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
