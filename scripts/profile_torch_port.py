#!/usr/bin/env python3
"""Where one CircuitAnalyzerTorch.analyze() spends its time on the card,
or, with --batch, the batched path.

    python3 scripts/profile_torch_port.py [--runs 3] [--sam2 t@512|l@1024]
    python3 scripts/profile_torch_port.py --product [--image ac_rc] [--runs 3]
    python3 scripts/profile_torch_port.py --batch 8 [--runs 3]

Builds a slice as chip_smoke.py does (YOLOv11-s@640 at the shapes of
ckpt/yolo/meta.json, and SAM2 Hiera-t@512 as ckpt/sam2/meta.json names
it, dtype included, or Hiera-L@1024, the default SAM2Config; seeded
weights, the same drawn schematic), or with --product the trained
product (ckpt/yolo in bf16, ckpt/sam2, the crop reader ckpt/reader as
the VLM client, all read by the port's own checkpoint reader) on one
eval image, analyze() followed by generate_final_netlist; warms up, then
prints JSON lines:

  * `stages`: per-stage wall time of each run (host clock, ms);
  * `device`: device time summed by kernel name under torch.profiler
    (device-side events only; top 20), the device-busy total and the
    run's wall time, whence the device's idle share (the profiler's own
    host overhead lengthens the wall time);
  * `host`: the host functions with the most cumulative time (cProfile,
    one run; it slows Python calls, so only the ranking is meaningful).

With --batch N (t@512, use_fused_morphology on, chip_smoke.py's 16
drawings of varied sizes) it prints `batch`: images/s of serial
analyze() and of analyze_batch(batch_size=N) for each of --runs runs;
host ms per chunk of each stage of one more analyze_batch (detect+crop,
segment + stage A queued, host stages with their fetch; a stage's time
includes its waits for the device); and, under torch.profiler,
analyze_batch's device-busy ms and idle share; with the card's
nvidia-smi name and power limit.

Needs a CUDA device; writes nothing.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def device_busy_ms(prof) -> float:
    """Device time of a profile: device-side events only (kernels, memcpy,
    memset); the CPU-side operator events carry the same time again."""
    import torch

    return sum(evt.self_device_time_total or evt.device_time_total
               for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def profile_batch(torch, batch_size: int, runs: int) -> None:
    from chip_smoke import batch_drawings
    from circuitvision_tpu_torch.core.config import PipelineConfig, TopologyConfig
    from circuitvision_tpu_torch.models.bridge import detector_config, sam2_config, seeded_state
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch
    from circuitvision_tpu_torch.pipeline.batch import BatchedPipeline

    ymeta = json.loads((REPO / "ckpt" / "yolo" / "meta.json").read_text())
    smeta = json.loads((REPO / "ckpt" / "sam2" / "meta.json").read_text())
    cfg = PipelineConfig(detector=detector_config(ymeta), sam2=sam2_config(smeta),
                         topology=TopologyConfig(use_fused_morphology=True))
    analyzer = CircuitAnalyzerTorch(cfg, seeded_state("yolo", ymeta, 0),
                                    seeded_state("sam2", smeta, 1), device="cuda")
    images = [img for img, _boxes in batch_drawings()]
    pipe = BatchedPipeline(analyzer, batch_size=batch_size)
    variants = {"serial_analyze": lambda: [analyzer.analyze(im) for im in images],
                "analyze_batch": lambda: pipe.analyze_many(images)}
    ips = {k: [] for k in variants}
    for fn in variants.values():
        fn()
    for _ in range(runs):
        for name, fn in variants.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ips[name].append(len(images) / (time.perf_counter() - t0))
    # host ms per call of each stage of one analyze_batch, waits included
    stage_ms = {name: [] for name in ("_detect_crop_phase", "_segment_phase", "_host_stages")}
    for name, times in stage_ms.items():
        def clocked(*a, _fn=getattr(pipe, name), _times=times):
            t0 = time.perf_counter()
            out = _fn(*a)
            _times.append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(pipe, name, clocked)
    pipe.analyze_many(images)
    torch.cuda.synchronize()
    for name in stage_ms:
        delattr(pipe, name)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipe.analyze_many(images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = device_busy_ms(prof)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"batch": {
        "images": len(images), "batch_size": batch_size, "images_per_s": ips,
        "stage_ms_per_chunk": stage_ms,
        "profiled": {"wall_ms": wall_ms, "device_busy_ms": busy,
                     "idle_share": 1.0 - busy / wall_ms},
        "card": smi}}))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--sam2", choices=("t@512", "l@1024"), default="t@512")
    ap.add_argument("--batch", type=int, default=0,
                    help="profile analyze_batch at this batch size instead of analyze()")
    ap.add_argument("--product", action="store_true",
                    help="the trained checkpoints and reader on an eval image, with the "
                         "final netlist")
    ap.add_argument("--image", default="ac_rc", help="eval_data/images/<name>.png (--product)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.batch:
        profile_batch(torch, args.batch, args.runs)
        return 0
    from chip_smoke import draw_schematic
    from circuitvision_tpu_torch.core.config import PipelineConfig
    from circuitvision_tpu_torch.models.bridge import detector_config, sam2_config, seeded_state
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch

    ymeta = json.loads((REPO / "ckpt" / "yolo" / "meta.json").read_text())
    if args.product:
        from circuitvision_tpu_torch.enrich.trained_reader import load_trained_reader
        from circuitvision_tpu_torch.io.image_io import load_image
        from circuitvision_tpu_torch.models.bridge import state_dict_from_variables
        from circuitvision_tpu_torch.models.checkpoint import load_model_checkpoint

        (yv, ymeta), (sv, smeta) = (load_model_checkpoint(str(REPO / "ckpt" / n))
                                    for n in ("yolo", "sam2"))
        cfg = PipelineConfig(detector=detector_config(ymeta), sam2=sam2_config(smeta))
        analyzer = CircuitAnalyzerTorch(
            cfg, state_dict_from_variables(yv), state_dict_from_variables(sv), device="cuda",
            vlm_client=load_trained_reader(str(REPO / "ckpt" / "reader")))
        image = load_image(str(REPO / "eval_data" / "images" / f"{args.image}.png"))
    else:
        if args.sam2 == "t@512":
            smeta = json.loads((REPO / "ckpt" / "sam2" / "meta.json").read_text())
            cfg = PipelineConfig(detector=detector_config(ymeta), sam2=sam2_config(smeta))
        else:
            smeta = {"sam2": {"preset": "l", "overrides": {}}}
            cfg = PipelineConfig(detector=detector_config(ymeta))
        analyzer = CircuitAnalyzerTorch(cfg, seeded_state("yolo", ymeta, 0),
                                        seeded_state("sam2", smeta, 1), device="cuda")
        image, _boxes = draw_schematic(0)

    def call():
        res = analyzer.analyze(image)
        return analyzer.generate_final_netlist(res) if args.product else res

    for _ in range(2):
        call()
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.runs):
            res = call()
            print(json.dumps({"stages": {k: v * 1e3 for k, v in res.timings.timings.items()}}))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.runs
    rows = []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            dev_us = evt.self_device_time_total or evt.device_time_total
            rows.append((dev_us / args.runs / 1e3, evt.count // args.runs, evt.key[:90]))
    rows.sort(reverse=True)
    busy_ms = device_busy_ms(prof) / args.runs
    print(json.dumps({"device": {
        "wall_ms_per_analyze": wall_ms, "device_busy_ms_per_analyze": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "top": [{"ms": ms, "calls": n, "name": k} for ms, n, k in rows[:20]]}}))

    prof_host = cProfile.Profile()
    prof_host.enable()
    call()
    torch.cuda.synchronize()
    prof_host.disable()
    stats = pstats.Stats(prof_host)
    top = sorted(stats.stats.items(), key=lambda kv: kv[1][3], reverse=True)[:25]
    print(json.dumps({"host": [{"cum_ms": v[3] * 1e3, "self_ms": v[2] * 1e3, "calls": v[1],
                                "fn": f"{Path(k[0]).name}:{k[1]}:{k[2]}"} for k, v in top]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device_name": torch.cuda.get_device_name(0), "card": smi,
                      "sam2": args.sam2, "sam2_dtype": cfg.sam2.dtype,
                      "product": args.image if args.product else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
