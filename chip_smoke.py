#!/usr/bin/env python3
"""Drive the PyTorch port (circuitvision_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the process exits non-zero:

  1. environment — torch/CUDA versions, the card's name and power limit,
     TF32 off for matmuls and convolutions;
  2. build — nvcc for every kernel source (started together) and g++ for
     the contour tracer, timed;
  3. kernels — each of the four kernels against its plain PyTorch
     version on the card, at every shape the t@512 slice launches it
     with, in bfloat16 and float32: error, tolerance, times, bound;
  4. main path — CircuitAnalyzerTorch.analyze() at YOLOv11-s@640 +
     SAM2 Hiera-t@512 (shapes from ckpt/*/meta.json, seeded weights,
     default dtypes) on a drawn ~1000×750 schematic: one warm-up, three
     timed runs with exact launch counts per call, then the same weights
     in float32 on the card against the CPU: YOLO's head outputs and
     SAM2's logits before any threshold, boxes after NMS, mask, netlist,
     and the topology and netlist of the drawing's classical wire mask
     with its drawn component boxes.

It prints one JSON line per kernel shape, a `kernels` summary line, the
card's `nvidia-smi` name/power line, and as its last line
{"ok": true, "device": {...}}. It reads only ckpt/*/meta.json and writes
only the package's build/ directory. Without a CUDA device it exits 1
and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

#: launches of each kernel in one analyze() at t@512 (12 Hiera blocks;
#: windowed blocks 0 and 2; q-pool transitions 1 and 3; one head)
EXPECTED_LAUNCHES = {"mlp_block": 12, "window_attn_block": 2, "qpool_attn_block": 2,
                     "refinement": 1}
#: the Pallas kernel each one replaces (function definition)
REPLACES = {
    "mlp_block": "circuitvision_tpu/ops/pallas/mlp_block.py:66",
    "window_attn_block": "circuitvision_tpu/ops/pallas/window_attn.py:264",
    "qpool_attn_block": "circuitvision_tpu/ops/pallas/window_attn.py:181",
    "refinement": "circuitvision_tpu/ops/pallas/refinement_fused.py:128",
}
SOURCES = {
    "mlp_block": "circuitvision_tpu_torch/csrc/mlp_block.cu",
    "window_attn_block": "circuitvision_tpu_torch/csrc/window_attn.cu",
    "qpool_attn_block": "circuitvision_tpu_torch/csrc/window_attn.cu",
    "refinement": "circuitvision_tpu_torch/csrc/refinement.cu",
}
#: H100 SXM peaks (NVIDIA data sheet, dense): memory, bf16 tensor, f32
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: float32 card vs float32 CPU: share of SAM2 mask pixels that must agree
MASK_AGREEMENT_MIN = 0.999
#: float32 card vs float32 CPU on the continuous outputs (YOLO's raw head
#: outputs per scale, SAM2's logits before the mask threshold):
#: max |card − cpu| ≤ this × max(1, max |cpu|). Only the summation order
#: differs (cuDNN/cuBLAS and the kernels against PyTorch's CPU code, TF32
#: off), through about 100 layers each; float32 against float64 on the
#: CPU differs by ≤ 5e-5 of max |ref| in YOLO's heads at small sizes.
#: What YOLO decodes from its heads is not compared: the seeded heads'
#: logits reach thousands, so a 1e-5 relative difference moves a sigmoid
#: score near 0.5 by hundredths and a near-tie of the box distribution's
#: softmax by most of a stride.
F32_PATH_RTOL = 1e-3


def tolerance(dt_name: str, ref_max: float) -> float:
    """Max |kernel − plain| allowed for an output of dtype `dt_name`.
    float32: 1e-4 × max(1, max |plain|),
    since the two differ only in summation order. bfloat16: two bf16 ulps
    at max |plain| — the output's own rounding is at most one, and a
    stored bf16 intermediate that rounds the other way moves the result
    by about one more. The f32 check is the one that holds the algorithm
    (the same kernel template runs both dtypes); the bf16 check holds its
    roundings."""
    if dt_name == "float32":
        return 1e-4 * max(1.0, ref_max)
    return 2.0 * 2.0 ** (math.floor(math.log2(max(ref_max, 2.0 ** -126))) - 7)


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0, name):
    print(f"   {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_cases(torch):
    """(name, shape label, per-analyze count, make(dtype, gen) → (kernel
    fn, plain fn, bytes, flops, dtype of the arithmetic)) for every shape
    of the t@512 slice."""
    from circuitvision_tpu_torch.ops.cuda import mlp_block as mb
    from circuitvision_tpu_torch.ops.cuda import refinement as rf
    from circuitvision_tpu_torch.ops.cuda import window_attn as wa

    def rnd(gen, dt, *shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dt)

    def mlp(t, c):
        def make(dt, gen):
            h = 4 * c
            args = (rnd(gen, dt, t, c), 1 + rnd(gen, dt, c, scale=0.1), rnd(gen, dt, c, scale=0.1),
                    rnd(gen, dt, h, c, scale=c ** -0.5), rnd(gen, dt, h, scale=0.02),
                    rnd(gen, dt, c, h, scale=h ** -0.5), rnd(gen, dt, c, scale=0.02))
            nbytes = sum(a.numel() * a.element_size() for a in args) + args[0].numel() * args[0].element_size()
            return (lambda: mb.mlp_block(*args), lambda: mb.mlp_block_plain(*args),
                    nbytes, 4 * t * c * h, dt)
        return make

    def window(nw, t, c, heads):
        def make(dt, gen):
            args = (rnd(gen, dt, nw, t, c), 1 + rnd(gen, dt, c, scale=0.1), rnd(gen, dt, c, scale=0.1),
                    rnd(gen, dt, 3 * c, c, scale=c ** -0.5), rnd(gen, dt, 3 * c, scale=0.02),
                    rnd(gen, dt, c, c, scale=c ** -0.5), rnd(gen, dt, c, scale=0.02))
            nbytes = sum(a.numel() * a.element_size() for a in args) + args[0].numel() * args[0].element_size()
            flops = nw * (2 * t * c * 3 * c + 4 * t * t * c + 2 * t * c * c)
            return (lambda: wa.window_attn_block(*args, heads=heads),
                    lambda: wa.window_attn_block_plain(*args, heads=heads), nbytes, flops, dt)
        return make

    def qpool(nw, win, ci, co, heads):
        def make(dt, gen):
            t = win * win
            args = (rnd(gen, dt, nw * t, ci), 1 + rnd(gen, dt, ci, scale=0.1), rnd(gen, dt, ci, scale=0.1),
                    rnd(gen, dt, co, ci, scale=ci ** -0.5), rnd(gen, dt, co, scale=0.02),
                    rnd(gen, dt, 3 * co, ci, scale=ci ** -0.5), rnd(gen, dt, 3 * co, scale=0.02),
                    rnd(gen, dt, co, co, scale=co ** -0.5), rnd(gen, dt, co, scale=0.02))
            nbytes = sum(a.numel() * a.element_size() for a in args) + nw * t // 4 * co * args[0].element_size()
            flops = nw * (2 * t * ci * co + 2 * t * ci * 3 * co + 4 * (t // 4) * t * co
                          + 2 * (t // 4) * co * co)
            return (lambda: wa.qpool_attn_block(*args, heads=heads, win=win),
                    lambda: wa.qpool_attn_block_plain(*args, heads=heads, win=win), nbytes, flops,
                    dt)
        return make

    def refine(h, w):
        def make(dt, gen):
            ws = [rnd(gen, dt, 4, 1, k, k, scale=k ** -1.0) for k in rf.KERNELS]
            bs = [rnd(gen, dt, 4, scale=0.1) for _ in rf.KERNELS]
            args = (rnd(gen, dt, 1, h, w, 1, scale=3.0), ws, bs, rnd(gen, dt, 1, 16, 1, 1, scale=0.25),
                    rnd(gen, dt, 1, scale=0.1))
            nbytes = args[0].numel() * args[0].element_size() + h * w * 4
            flops = h * w * (2 * 4 * sum(k * k for k in rf.KERNELS) + 2 * 16)
            # the head's arithmetic is float32 whatever the logits' dtype
            return (lambda: rf.refinement(*args), lambda: rf.refinement_plain(*args), nbytes, flops,
                    torch.float32)
        return make

    return [
        ("mlp_block", "T=16384 C=96", 1, mlp(16384, 96)),
        ("mlp_block", "T=4096 C=192", 2, mlp(4096, 192)),
        ("mlp_block", "T=1024 C=384", 7, mlp(1024, 384)),
        ("mlp_block", "T=256 C=768", 2, mlp(256, 768)),
        ("window_attn_block", "256 windows x 64 tokens C=96 heads=1", 1, window(256, 64, 96, 1)),
        ("window_attn_block", "256 windows x 16 tokens C=192 heads=2", 1, window(256, 16, 192, 2)),
        ("qpool_attn_block", "256 windows win=8 C=96->192 heads=2", 1, qpool(256, 8, 96, 192, 2)),
        ("qpool_attn_block", "256 windows win=4 C=192->384 heads=4", 1, qpool(256, 4, 192, 384, 4)),
        ("refinement", "1x512x512", 1, refine(512, 512)),
    ]


def run_kernels(torch):
    """Phase 3. Returns per-kernel sums over one analyze()'s launches in
    bfloat16 (the main path's dtype) and the worst error seen."""
    summary = {}
    for name, label, count, make in kernel_cases(torch):
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            gen = torch.Generator(device="cuda").manual_seed(0)
            kern, plain, nbytes, flops, math_dt = make(dt, gen)
            out = kern()
            got, ref = out.float(), plain().float()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            # the tolerance follows what the kernel stores: the refinement
            # head returns float32 whatever its input's dtype
            tol = tolerance(str(out.dtype).removeprefix("torch."), float(ref.abs().max()))
            if not torch.isfinite(got).all() or err > tol:
                raise AssertionError(f"{name} [{label}, {dt_name}]: max |kernel - plain| "
                                     f"{err:.3e} > tol {tol:.3e}")
            k_ms, p_ms = cuda_ms(kern), cuda_ms(plain, iters=5)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[str(math_dt).removeprefix("torch.")] * 1e3
            row = {"kernel": name, "shape": label, "dtype": dt_name, "max_abs_err": err,
                   "tol": tol, "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": None,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "launches_per_analyze": count}
            print(json.dumps(row), flush=True)
            if dt_name == "bfloat16":
                s = summary.setdefault(name, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                              "t_bytes": 0.0, "t_ops": 0.0, "max_abs_err": 0.0})
                s["ms"] += count * k_ms
                s["plain_ms"] += count * p_ms
                s["bound_ms"] += count * row["bound_ms"]
                s["t_bytes"] += count * t_bytes
                s["t_ops"] += count * t_ops
            summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], err)
    return summary


def draw_schematic(seed: int, h: int = 750, w: int = 1000):
    """A white RGB page with a black wire loop, a cross wire and eight
    outlined component bodies on the wires, drawn with numpy. Returns the
    image and the bodies' (xmin, ymin, xmax, ymax) boxes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 255, np.uint8)
    x0, x1, y0, y1 = 120, w - 120, 110, h - 110
    t = 3
    img[y0:y0 + t, x0:x1] = 0
    img[y1:y1 + t, x0:x1] = 0
    img[y0:y1 + t, x0:x0 + t] = 0
    img[y0:y1 + t, x1:x1 + t] = 0
    xm = (x0 + x1) // 2
    img[y0:y1, xm:xm + t] = 0
    boxes = []
    spots = [(y0, x0 + 130), (y0, x1 - 150), (y1, x0 + 160), (y1, x1 - 140),
             (y0 + 170, x0), (y1 - 160, x1), ((y0 + y1) // 2, xm), (y0 + 90, xm)]
    for cy, cx in spots:
        bh, bw = rng.integers(36, 60), rng.integers(60, 100)
        if cx in (x0, x1, xm):
            bh, bw = bw, bh
        ys, xs = cy - bh // 2, cx - bw // 2
        img[ys:ys + bh, xs:xs + bw] = 255
        img[ys:ys + bh, xs:xs + t] = 0
        img[ys:ys + bh, xs + bw - t:xs + bw] = 0
        img[ys:ys + t, xs:xs + bw] = 0
        img[ys + bh - t:ys + bh, xs:xs + bw] = 0
        boxes.append((int(xs), int(ys), int(xs + bw - 1), int(ys + bh - 1)))
    return img, boxes


def run_main_path(torch):
    """Phase 4. Returns the launches of each kernel in one analyze()."""
    import numpy as np

    from circuitvision_tpu_torch.core.config import PipelineConfig
    from circuitvision_tpu_torch.core.types import BBox
    from circuitvision_tpu_torch.models.bridge import detector_config, sam2_config, seeded_state
    from circuitvision_tpu_torch.models.yolo.decode import STRIDES
    from circuitvision_tpu_torch.netlist.generate import (
        generate_netlist_from_nodes, stringify_netlist,
    )
    from circuitvision_tpu_torch.ops.cuda import mlp_block as mb
    from circuitvision_tpu_torch.ops.cuda import refinement as rf
    from circuitvision_tpu_torch.ops.cuda import window_attn as wa
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch
    from circuitvision_tpu_torch.topology.nodes import extract_nodes
    from circuitvision_tpu_torch.topology.reclassify import segment_classical

    wrappers = {"mlp_block": mb.mlp_block, "window_attn_block": wa.window_attn_block,
                "qpool_attn_block": wa.qpool_attn_block, "refinement": rf.refinement}
    ymeta = json.loads((REPO / "ckpt" / "yolo" / "meta.json").read_text())
    smeta = json.loads((REPO / "ckpt" / "sam2" / "meta.json").read_text())
    cfg = PipelineConfig(detector=detector_config(ymeta), sam2=sam2_config(smeta))
    print(f"   config: YOLOv11-{cfg.detector.scale}@{cfg.detector.img_size} "
          f"({cfg.detector.num_classes} classes, {cfg.detector.dtype}) + SAM2 Hiera "
          f"embed {cfg.sam2.embed_dim} stages {tuple(cfg.sam2.stages)}@{cfg.sam2.resolution} "
          f"({cfg.sam2.dtype})", flush=True)
    ystate, sstate = seeded_state("yolo", ymeta, 0), seeded_state("sam2", smeta, 1)
    image, drawn_boxes = draw_schematic(0)

    analyzer = CircuitAnalyzerTorch(cfg, ystate, sstate, device="cuda")
    t0 = time.perf_counter()
    analyzer.analyze(image)
    print(f"   warm-up analyze: {time.perf_counter() - t0:.3f} s", flush=True)
    launches = None
    for run in range(3):
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = analyzer.analyze(image)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
        counts = {k: fn.launches for k, fn in wrappers.items()}
        stages = {k: round(v * 1e3, 3) for k, v in res.timings.timings.items()}
        print(json.dumps({"analyze_run": run, "total_ms": total_ms, "stages_ms": stages,
                          "launches": counts, "boxes": len(res.bboxes_orig_nms),
                          "nodes": len(res.nodes)}), flush=True)
        if counts != EXPECTED_LAUNCHES:
            raise AssertionError(f"launches per analyze {counts} != {EXPECTED_LAUNCHES}")
        if res.sam_mask is None or res.sam_mask_display is None:
            raise AssertionError("SAM2 produced no mask")
        if res.node_mask is None:
            raise AssertionError("node analysis raised (see the log above)")
        if res.sam_mask.shape != res.image_for_analysis.shape[:2]:
            raise AssertionError("SAM2 mask shape differs from the analysed image")
        launches = counts

    # float32 on the card against float32 on the CPU, same weights and image
    cfg32 = dataclasses.replace(
        cfg, detector=dataclasses.replace(cfg.detector, dtype="float32"),
        sam2=dataclasses.replace(cfg.sam2, dtype="float32"))
    card32 = CircuitAnalyzerTorch(cfg32, ystate, sstate, device="cuda")
    cpu32 = CircuitAnalyzerTorch(cfg32, ystate, sstate, device="cpu")
    gpu = card32.analyze(image)
    t0 = time.perf_counter()
    cpu = cpu32.analyze(image)
    print(f"   cpu float32 analyze: {time.perf_counter() - t0:.3f} s", flush=True)

    # the continuous outputs, before any threshold: every layer of YOLO
    # and of SAM2 (Hiera with its four kernels, neck, decoder, refinement
    # head) shows in them, whatever the seeded weights make of the mask
    def path_err(name, got, ref):
        got, ref = got.float().cpu(), ref.float()
        err = float((got - ref).abs().max())
        tol = F32_PATH_RTOL * max(1.0, float(ref.abs().max()))
        if got.shape != ref.shape or not torch.isfinite(got).all() or err > tol:
            raise AssertionError(f"{name}: card vs cpu max |diff| {err:.3e} > tol {tol:.3e}")
        return {"max_abs_err": err, "tol": tol, "ref_max_abs": float(ref.abs().max())}

    g_heads, c_heads = card32.yolo_heads(image)[0], cpu32.yolo_heads(image)[0]
    continuous = {f"yolo_head_stride{s}": path_err(f"YOLO head, stride {s}", g, c)
                  for s, g, c in zip(STRIDES, g_heads, c_heads)}
    continuous["sam2_logits"] = path_err("SAM2 logits", card32.segment_logits(image),
                                         cpu32.segment_logits(image))

    key = lambda bs: [(b.class_name, b.xmin, b.ymin, b.xmax, b.ymax) for b in bs]  # noqa: E731
    boxes_equal = key(gpu.bboxes_orig_nms) == key(cpu.bboxes_orig_nms)
    agreement = float(np.mean(gpu.sam_mask == cpu.sam_mask)) \
        if gpu.sam_mask.shape == cpu.sam_mask.shape else 0.0
    netlist_equal = gpu.netlist_text == cpu.netlist_text

    # the mask, topology and netlist stages on wires with real structure:
    # seeded SAM2 weights give a near-uniform mask and seeded YOLO boxes
    # cover the drawing, so stages [5] and [6] run here on the classical
    # mask of the drawing with the drawn component boxes, card against cpu
    drawn = [BBox("resistor", 1.0, *b, class_id=10) for b in drawn_boxes]

    def topology(device):
        mask = segment_classical(image, cfg32.topology, device=device)
        ex = extract_nodes(mask, drawn, cfg32.topology, device=device)
        text = stringify_netlist(generate_netlist_from_nodes(ex.nodes)) if ex.nodes else ""
        return len(ex.nodes), text

    (g_nodes, g_text), (c_nodes, c_text) = topology("cuda"), topology("cpu")
    drawn_check = {"netlist_equal": g_text == c_text, "nodes": [g_nodes, c_nodes],
                   "netlist_lines": len(g_text.splitlines())}
    print(json.dumps({"f32_card_vs_cpu": {
        "continuous": continuous,
        "boxes_equal": boxes_equal, "n_boxes": len(gpu.bboxes_orig_nms),
        "mask_agreement": agreement, "mask_agreement_min": MASK_AGREEMENT_MIN,
        "sam2_mask_foreground_share": float(np.mean(gpu.sam_mask > 0)),
        "netlist_equal": netlist_equal, "netlist_lines": len(gpu.netlist_text.splitlines()),
        "nodes": [len(gpu.nodes), len(cpu.nodes)], "drawn_topology": drawn_check}}),
          flush=True)
    if not boxes_equal:
        raise AssertionError(f"boxes differ: card {key(gpu.bboxes_orig_nms)} "
                             f"cpu {key(cpu.bboxes_orig_nms)}")
    if agreement < MASK_AGREEMENT_MIN:
        raise AssertionError(f"SAM2 mask agreement {agreement} < {MASK_AGREEMENT_MIN}")
    if not netlist_equal:
        raise AssertionError(f"netlists differ:\n{gpu.netlist_text}\n--\n{cpu.netlist_text}")
    if g_text != c_text or g_nodes != c_nodes:
        raise AssertionError(f"drawn-topology netlists differ:\n{g_text}\n--\n{c_text}")
    if g_nodes < 2:
        raise AssertionError(f"the drawing gave {g_nodes} nodes; the topology was not exercised")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from circuitvision_tpu_torch.ops.cuda.build import build_all
    from circuitvision_tpu_torch.topology import contours

    t0 = phase("environment")
    print(f"   torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    done(t0, "environment")

    t0 = phase("build")
    build_all()
    contours.load_library()
    done(t0, "build (nvcc for every kernel, g++ for the contour tracer)")

    t0 = phase("kernels")
    summary = run_kernels(torch)
    done(t0, "kernels")

    t0 = phase("main path")
    launches = run_main_path(torch)
    done(t0, "main path")

    kernels = []
    for name, s in summary.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes" if s["t_bytes"] >= s["t_ops"] else "operations",
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
