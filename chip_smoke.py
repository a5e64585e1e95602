#!/usr/bin/env python3
"""Drive the PyTorch port (circuitvision_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the process exits non-zero:

  1. environment — torch/CUDA versions, the card's name and power limit,
     TF32 off for matmuls and convolutions;
  2. build — nvcc for every kernel source (started together) and g++ for
     the contour tracer, the PNG and JPEG decoders and the rasteriser of
     the debug drawings, timed; the launch floor — an empty
     kernel of the repo's own (csrc/launch_floor.cu) timed as the kernel
     rows are;
  3. kernels at t@512 — the four kernels of that slice against their
     plain PyTorch versions on the card, at every shape the t@512 slice
     launches them with, in bfloat16 and float32: error, tolerance,
     times, bound. Every kernel row (here and below) gives its device
     time, `kernel_ms` — 20 calls captured in one CUDA graph, replays
     timed between events, divided by the calls — and beside it
     `eager_ms`, 20 eager calls between events, which holds each call's
     Python dispatch; library and `F.linear` times are device times, the
     plain version's eager. The float32 rows of mlp_block,
     window_attn_block and qpool_attn_block, whose products run as three
     TF32 products on the tensor cores, take 3 × ops ÷ 495 TFLOP/s as
     their bound ("3xTF32 operations", `fma_bound_ms` the FMA units'
     bound beside it) and the sum of their products' cuBLAS float32
     `F.linear` calls as `library_ms` (the window block's with
     F.scaled_dot_product_attention on the same q, k, v); a
     `kernels_t512_f32` line sums the float32 rows over the trained
     product's launches;
  4. main path at t@512 — CircuitAnalyzerTorch.analyze() at YOLOv11-s@640
     + SAM2 Hiera-t@512 (shapes and SAM2's dtype from ckpt/*/meta.json,
     seeded weights) on a drawn ~1000×750 schematic: one warm-up, three
     timed runs with exact launch counts per call, then the same weights
     in float32 on the card against the CPU: YOLO's head outputs and
     SAM2's logits before any threshold, boxes after NMS, mask, netlist,
     and the topology and netlist of the drawing's classical wire mask
     with its drawn component boxes;
  5. kernels at L@1024 — all seven kernels against their plain versions
     at every shape the Hiera-L@1024 path launches them with, and the
     shapes only its float32 route launches (SDPA timed beside flash
     attention as its library yardstick; the six Hiera kernels' rows,
     here and at t@512, also print their rate in TFLOP/s; the ln_qkv and
     attn_proj_residual rows one `F.linear`'s time, cuBLAS's product
     alone), then the bf16 launch plans of flash_attn, mlp_block, ln_qkv
     and attn_proj_residual against the kernels' own shared-memory sizes,
     the window and q-pool blocks at every L@1024 window shape through
     both routes (the one-block kernel where the route rule gives it,
     and the tiled route), and the route rule against the kernels' own
     shared-memory sizes in both dtypes;
  6. main path at L@1024 — analyze() at YOLOv11-s@640 + SAM2 Hiera-L@1024
     (the default SAM2Config, bfloat16, seeded weights): one warm-up,
     three timed runs with exact launch counts, then SAM2's logits in
     float32 on the card against the CPU at the full 48-block depth;
  6b. the reference deployment from the reference's checkpoints —
     seeded YOLOv11-l@640 (62 classes) and SAM2.1-L@1024 weights saved
     as flat state dicts in the reference's naming (an ultralytics-nested
     `model.model.*` .pt with the DFL arange and a num_batches_tracked a
     BatchNorm, not ultralytics' pickled DetectionModel; a PEFT-wrapped
     SAM2.1 .pth with seeded rank-4 adapters on all 36
     REFERENCE_LORA_TARGETS and video-memory entries), their keys held to
     the frozen inventories of tests/fixtures; converted by the port's
     command line (`python -m circuitvision_tpu_torch.models.checkpoint
     convert-yolo|convert-sam2`) in processes, read back by the port's
     reader and held leaf for leaf to the seeded weights with the same
     numpy fold; then the default PipelineConfig() (bfloat16) from the
     read-back weights: one warm-up, three timed runs with exact launch
     counts (L@1024's), boxes, nodes and netlist equal to an analyzer
     handed the expected weights in memory, YOLO heads and SAM2 logits
     within F32_PATH_RTOL of it; the CLI's `analyze` on the converted
     directories in a process, its detections and netlist the
     in-process ones (the netlist is empty at seeded weights, so the
     detections and the heads carry that check); both analyzers again
     with the drawing's eight component bodies injected as the
     detections (as --oracle-boxes injects them), once with SAM2's mask
     (seeded, it marks nearly the whole page: one node, an empty
     netlist) and once with the classical mask: the netlists equal
     across the weights, the classical one not empty; YOLOv11-l float32 heads
     on the card against the CPU; s to convert and to write (as the
     converter prints them), s to read back, bytes written;
  7. batched path — analyze_batch (BatchedPipeline.analyze_many) at
     s@640 + t@512 with use_fused_morphology on, over 16 drawings in
     chunks of 8: exact launch counts (the line enhancement once per
     image), the same boxes, node counts and netlists as the card's own
     analyze() with masks agreeing on ≥ 99.9 %, the drawn topology with
     the switch on and off on the card and on the CPU, and images/s of
     analyze_many against serial analyze();
  8. the line-enhancement kernel, bit-exact, at every raster shape the
     batched path's drawn topology ran it at (its row in the `kernels`
     line: those launches and times), and as rows off the count at the
     seeded-weight run's shapes, 600×800 and 600×1003;
  8b. trained product — the shipped ckpt/yolo, ckpt/sam2 and the crop
     reader ckpt/reader, read by the port's orbax reader (libzstd through
     ctypes), and the first 16 eval_data PNGs and their masks, read by
     the port's PNG reader: card against CPU in float32 on two images
     (boxes, SAM2 logits, mask, the reader's rows and directions, final
     netlist); then in the shipped dtypes analyze() +
     generate_final_netlist over the 16 (timed, exact launch counts, SAM2
     foreground share strictly inside (0, 1) wherever the ground truth
     has wires, mask IoU), analyze_many(finalize=True) in chunks of 8
     with the line enhancement kernel on (timed, exact launch counts,
     each netlist the serial one), and netlist exact match against
     eval_data/netlists, reported;
  8c. serving, simulation and the CLI on the trained product — `serve`'s
     pieces (BatchedPipeline in chunks of 8 with the line enhancement
     kernel, BatchingExecutor(final=True), make_server on an ephemeral
     port) with 8 client threads POSTing the 16 eval PNGs, a warm-up
     and 5 timed rounds:
     every served netlist analyze_many(finalize=True)'s, exact launch
     counts per round, /stats, /metrics, a body that is not a PNG
     answered 500; served images/s, p50/p99 latency and mean batch size
     beside analyze_many's images/s; analyzer.simulate on each served
     result and the 63 eval netlists with the native solver (g++, timed)
     against numpy; the CLI's `simulate` and `analyze` (shipped
     checkpoints, the reader, --simulate dc) as subprocesses, its
     netlist the serial analyze()'s;
  8d. image input and the web UI on the trained product — every fixture
     of eval_data/image_fixtures (JPEGs of each kind the reader takes,
     PNG variants) decoded by the port and held to the SHA-256 of PIL's
     decode (digests.json; the card has no PIL); decode ms per image for
     the eval JPEGs, the photo-sized
     JPEG and the eval PNGs; then the port's webapp (make_server on an
     ephemeral port) POSTed each eval JPEG and each eval PNG: every
     netlist the analyzer's analyze() on the same decoded pixels, every
     debug image in the response decoding to the array core/viz draws
     (the annotated images drawn again from the result), exact launch
     counts per request, request ms beside analyze() ms; and the FLOP
     count (models/flops.py) of one trained-product analyze() and one
     L@1024 analyze(), with the rate it implies at this run's times;
  8e. the black-box VLM value pass on the trained product's YOLOv11-s@640
     and SAM2 t@512 (ckpt/yolo, ckpt/sam2, no reader): a stub HTTP
     server on 127.0.0.1, in a thread, answers Gemini's generateContent
     and OpenRouter's chat/completions from eval_data/labels (the
     values of the image being read; a direction by the prompt's kind,
     from the label file's first voltage or diode class); analyze() +
     generate_final_netlist over the 16 eval PNGs with GeminiVLMClient,
     with OpenRouterVLMClient and with a FakeVLMClient giving the same
     answers: the HTTP clients' netlists the fake's, every PNG the stub
     received the drawn enumeration image, that image the one
     enumerate_components draws again from the result, exact launch
     counts per analyze(); ms per image of the drawing, of each round
     trip and of analyze() + final netlist, netlist exact match against
     eval_data/netlists; analyze_many(finalize=True) in chunks of 8 with
     a fake that replays each image's values (by its enumeration
     image), equal to the serial path, exact launch counts; then
     scripts/torch_eval_pipeline.py as a process over the 63 eval images
     with the shipped checkpoints and label replay, its report on a line
     of its own;
  9. off-preset head widths — bf16 Hiera trunks on the card against
     their float32 forward on the CPU, with exact launch counts: head
     width 64 (OFF_PRESET: every window and q-pool block on the tiled
     route, the global block on flash attention), 60 (heads padded to 64;
     stage 1 and its transition, whose width 60 is off a multiple of 8,
     on the bf16 kernels with rows zero-padded to 64 and the LayerNorm
     dividing by 60, their mlp_block and ln_qkv launches held to the
     plain versions and timed beside the float32 kernels those blocks
     ran before) and 136 (flash_attn's 136 instance);
 10. the trunk LayerNorm option — TrunkLayerNorm(fused=True), alone and
     with residual=, at the four Hiera-L@1024 trunk widths, with exact
     launch counts — and its two kernels there in bf16 and f32;
 11. the fine-tune's kernels — FlashAttention's lse forward (K1) and its
     dq and dkv backward kernels (K3, K2) at SAM2.1-L's global shape,
     1 × 8 heads × 4096 × 72, and at Hiera-t@1024's, 1 × 4 × 4096 × 96,
     in bf16 and f32 against their plain versions, SDPA and SDPA's
     backward (through autograd, timed by CUDA-graph replay as the
     kernels are) beside them;
 12. the fine-tune — L_CUT whole-tree in float32 with TF32 off, the
     card's gradients against the port's CPU gradients on every leaf;
     SAM2.1-L@1024 in bf16 (every float leaf cast, LayerNorm's too):
     the whole-tree step at batch 1 and 4 (path A) and, at batch 4, the
     selective step at the reference's surface and the rank-4 LoRA step
     (path B) — ms per step (median of 5 after a warm-up), images/s,
     peak memory, the loss falling over the steps on one batch, exact
     launch counts per step; SAM2.1 Hiera-t@1024 in bf16, seeded, the
     whole-tree step at batch 1 and 4 (its global heads of width 96 on
     FlashAttention's 96 instances); then the shipped ckpt/sam2 (t@512
     float32) trained whole-tree on eval_data through the port's folder
     dataset in batches of 8 (path C), which launches no kernel;
 13. training the detector and the reader — a 128-item pool rendered by
     eval/pool.write_pool (handdrawn 0.25, degrade 0.40; host ms per item
     by kind and degrade tier; the sha256 of pinned items against the
     JAX package's renders, POOL_ITEM_DIGESTS) and letterboxed to 640 by
     load_pool; YOLOv11-s@640, 64 classes, float32, from seeded random
     weights through train/yolo_train.train_detector (batch 16, 40 steps,
     warm-up 5, 32 held out: ms per step, peak memory, losses, fg,
     skipped, mAP@50 before and after); the detector's step card against
     CPU at batch 2 (loss, assignment, every leaf's gradient, the
     BatchNorm statistics included); the reader (ReaderConfig(), batch
     256, 60 steps) on generate_reader_dataset of 64 circuits through
     train/reader.train_reader, evaluate_product on 16 held-out circuits,
     and its step's gradients card against CPU; the trained detector and
     reader written as the JAX trainers write them (orbax + meta.json; a
     bare orbax directory), read back equal leaf for leaf, and the
     written detector's heads those of the in-memory parameters, and
     scripts/torch_eval_detector.py as a process on the pool's held-out
     tail for the written detector and for the shipped ckpt/yolo, their
     AP@50 tables printed. No
     kernel lies on this path: every count must stay 0.

It prints one JSON line per kernel shape and route check, the launch
floor, one line per fine-tune path, a `kernels` summary line (every
ported kernel with its launches, device and eager times on the path that
runs it; FlashAttention's three at L@1024, and again at t@1024 on a
`kernels_train_t1024` line before it), the card's
`nvidia-smi` name/power line, and as its
last line {"ok": true, "device": {...}}. It reads ckpt/, eval_data/ and
tests/fixtures/ and writes only the package's build/ directory and, in
temporary directories it removes, phase 6b's checkpoints and phase 13's
pool and saved models. Without a CUDA device it exits 1 and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

#: launches of each kernel in one analyze(), and the window and q-pool
#: calls that took the tiled route. t@512: 12 Hiera blocks; windowed
#: blocks 0 and 2; q-pool transitions 1 and 3; global blocks below the
#: flash threshold; one head. L@1024 (bf16): 48 blocks; windowed blocks
#: 0-1 and 3-7 in one block per window, the 32 stage-3 and 3 stage-4
#: windows tiled; q-pool 2 and 8 in one block, 44 tiled; global 23, 33,
#: 43. The tiled calls launch ln_qkv (twice for a q-pool: q/k/v and the
#: shortcut), flash_attn and attn_proj_residual once each.
#: the fine-tune's kernels (FlashAttention: the forward with its lse, the
#: two backward kernels), which no serving path launches
TRAIN_KERNELS = ("flash_attn_lse", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")
EXPECTED = {
    "t@512": {"mlp_block": 12, "window_attn_block": 2, "qpool_attn_block": 2, "refinement": 1,
              "ln_qkv": 0, "flash_attn": 0, "attn_proj_residual": 0,
              "enhance_lines_fused": 0, "fused_layernorm": 0, "fused_add_layernorm": 0,
              "window_attn_block.tiled": 0, "qpool_attn_block.tiled": 0,
              **{k: 0 for k in TRAIN_KERNELS}},
    "l@1024": {"mlp_block": 48, "window_attn_block": 7, "qpool_attn_block": 2, "refinement": 1,
               "ln_qkv": 40, "flash_attn": 39, "attn_proj_residual": 39,
               "enhance_lines_fused": 0, "fused_layernorm": 0, "fused_add_layernorm": 0,
               "window_attn_block.tiled": 35, "qpool_attn_block.tiled": 1,
               **{k: 0 for k in TRAIN_KERNELS}},
}
#: the reference deployment (PipelineConfig(): YOLOv11-l@640 + SAM2.1-L@1024,
#: bf16) launches what L@1024 launches: YOLO has no kernel
EXPECTED["reference"] = EXPECTED["l@1024"]
#: the batched path at s@640 + t@512: BATCH_IMAGES drawings in chunks of
#: BATCH_SIZE; the Hiera kernels launch once per chunk (the chunk's crops
#: are one batch), the line enhancement once per image with a mask
BATCH_IMAGES, BATCH_SIZE = 16, 8
BATCH_CHUNKS = -(-BATCH_IMAGES // BATCH_SIZE)
EXPECTED["batch"] = {**{k: v * BATCH_CHUNKS for k, v in EXPECTED["t@512"].items()},
                     "enhance_lines_fused": BATCH_IMAGES}
#: the trunk LayerNorm option at the four Hiera-L@1024 widths: each
#: TrunkLayerNorm(fused=True) called once alone and once with residual=
L_TRUNK_ROWS = [(65536, 144), (16384, 288), (4096, 576), (1024, 1152)]
EXPECTED["trunk-ln"] = {**{k: 0 for k in EXPECTED["t@512"]},
                        "fused_layernorm": len(L_TRUNK_ROWS),
                        "fused_add_layernorm": len(L_TRUNK_ROWS)}
#: operations per pixel of the line enhancement (blur 2 × (5 products +
#: 4 sums), round, 4 × 8 comparisons) and per element of a LayerNorm
#: (two sums and a square for the statistics; subtract, two products and
#: a sum for the affine)
MORPH_OPS_PER_PIXEL = 51
LN_OPS_PER_ELEMENT = 7
#: the TPU kernel each one replaces (function definition; jax's own flash
#: attention by the line that calls it)
REPLACES = {
    "mlp_block": "circuitvision_tpu/ops/pallas/mlp_block.py:66",
    "window_attn_block": "circuitvision_tpu/ops/pallas/window_attn.py:264",
    "qpool_attn_block": "circuitvision_tpu/ops/pallas/window_attn.py:181",
    "refinement": "circuitvision_tpu/ops/pallas/refinement_fused.py:128",
    "ln_qkv": "circuitvision_tpu/ops/pallas/global_attn.py:61",
    "flash_attn": "circuitvision_tpu/models/sam2/hiera.py:487",
    "attn_proj_residual": "circuitvision_tpu/ops/pallas/global_attn.py:133",
    "enhance_lines_fused": "circuitvision_tpu/ops/pallas/fused_morphology.py:121",
    "fused_layernorm": "circuitvision_tpu/ops/pallas/fused_ln.py:62",
    "fused_add_layernorm": "circuitvision_tpu/ops/pallas/fused_ln.py:96",
    # jax's TPU flash attention on the JAX package's training path
    # (hiera.py:270 under jax.value_and_grad): its forward with residuals
    # (jax flash_attention.py:589, call :758) and backward kernels
    "flash_attn_lse": "circuitvision_tpu/models/sam2/hiera.py:270",
    "flash_attn_bwd_dkv": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
    "flash_attn_bwd_dq": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
}
SOURCES = {
    "mlp_block": "circuitvision_tpu_torch/csrc/mlp_block.cu",
    "window_attn_block": "circuitvision_tpu_torch/csrc/window_attn.cu",
    "qpool_attn_block": "circuitvision_tpu_torch/csrc/window_attn.cu",
    "refinement": "circuitvision_tpu_torch/csrc/refinement.cu",
    "ln_qkv": "circuitvision_tpu_torch/csrc/global_attn.cu",
    "flash_attn": "circuitvision_tpu_torch/csrc/flash_attn.cu",
    "attn_proj_residual": "circuitvision_tpu_torch/csrc/global_attn.cu",
    "enhance_lines_fused": "circuitvision_tpu_torch/csrc/morphology.cu",
    "fused_layernorm": "circuitvision_tpu_torch/csrc/fused_ln.cu",
    "fused_add_layernorm": "circuitvision_tpu_torch/csrc/fused_ln.cu",
    "flash_attn_lse": "circuitvision_tpu_torch/csrc/flash_attn.cu",
    "flash_attn_bwd_dkv": "circuitvision_tpu_torch/csrc/flash_bwd.cu",
    "flash_attn_bwd_dq": "circuitvision_tpu_torch/csrc/flash_bwd.cu",
}
#: the window and q-pool block shapes of L@1024: (windows, tokens,
#: width, heads) and (windows, window side, width in, width out, heads)
L_WINDOWS = [(1024, 64, 144, 2), (1024, 16, 288, 4), (16, 256, 576, 8), (16, 64, 1152, 16)]
L_QPOOLS = [(1024, 8, 144, 288, 4), (1024, 4, 288, 576, 8), (16, 16, 576, 1152, 16)]
#: kernels whose rows also print their rate, operations ÷ kernel time
TFLOPS_ROWS = ("flash_attn", "mlp_block", "ln_qkv", "window_attn_block", "attn_proj_residual",
               "flash_attn_lse", "flash_attn_bwd_dq", "flash_attn_bwd_dkv",
               "qpool_attn_block")
#: H100 SXM peaks (NVIDIA data sheet, dense): memory, bf16 tensor, f32
#: on the FMA units, tf32 tensor
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
#: the float32 kernels that run every product as three TF32 products on
#: the tensor cores (csrc/tf32.cuh): their bound is 3 × ops ÷ the tf32
#: peak, the FMA bound (ops ÷ the f32 peak) printed beside it
TF32X3_KERNELS = ("mlp_block", "window_attn_block", "qpool_attn_block")
#: the trained product's SAM2 stage (analyzer StageTimings)
SAM2_STAGE = "SAM2 Segmentation on YOLO-Cropped Image"
#: the off-preset head-width check: SAM2.1-L's
#: layout — its window spec, a global block in stage 3 — at embed 128 and
#: 2 heads, so every stage's head width is 64, outside the block kernels'
#: 56/72/96; resolution 768 (a 48² stage-3 map, 2304 tokens, over the
#: flash threshold) and depth cut to stages (1, 1, 3, 1). In bf16 on the
#: card every window and q-pool block takes the tiled route and the
#: global block flash attention.
OFF_PRESET = dict(resolution=768, embed_dim=128, num_heads=2, stages=[1, 1, 3, 1],
                  global_att_blocks=[3], backbone_channel_list=[1024, 512, 256, 128])
EXPECTED["off-preset"] = {**{k: 0 for k in EXPECTED["t@512"]},
                          "mlp_block": 6, "ln_qkv": 9, "flash_attn": 6, "attn_proj_residual": 6,
                          "window_attn_block.tiled": 2, "qpool_attn_block.tiled": 3}
#: the same layout at head widths off the bf16 kernels' own instances.
#: Width 60, one head: stage 1 (C = 60) and the 60 → 120 transition are
#: off a multiple of 8 and run the bf16 kernels on rows zero-padded to 64
#: (hiera.pad_block), their window and q-pool halves on the tiled route;
#: from C = 120 on, bf16 with the heads padded to 64 on the tiled route
#: and the global block's route (resolution 768: a 48² stage-3 map over
#: the flash threshold) — the launches of width 64. Width 136, one head:
#: every window and q-pool block tiled on flash_attn's 136 instance; the
#: global block (hd > 128) on the module path, as in the JAX trunk;
#: resolution 512.
OFF_PRESET_60 = dict(resolution=768, embed_dim=60, num_heads=1, stages=[1, 1, 3, 1],
                     global_att_blocks=[3], backbone_channel_list=[480, 240, 120, 60])
EXPECTED["off-preset-60"] = EXPECTED["off-preset"]
#: the padded route's rows at width 60: OFF_PRESET_60's stage-1 map
#: (resolution 768 / 4)² tokens
WIDTH60_ROWS = (768 // 4) ** 2
OFF_PRESET_136 = dict(resolution=512, embed_dim=136, num_heads=1, stages=[1, 1, 3, 1],
                      global_att_blocks=[3], backbone_channel_list=[1088, 544, 272, 136])
EXPECTED["off-preset-136"] = {**{k: 0 for k in EXPECTED["t@512"]},
                              "mlp_block": 6, "ln_qkv": 8, "flash_attn": 5,
                              "attn_proj_residual": 5, "window_attn_block.tiled": 2,
                              "qpool_attn_block.tiled": 3}
#: the fine-tune, launches per step. Whole-tree at L@1024 (path A): every
#: block and the refinement head on the module path, the global blocks 23,
#: 33 and 43 through FlashAttention — the lse forward, then the dq and the
#: dkv kernel in the backward — and no forward kernel of rows 1-8; L_CUT
#: has one global block. Selective at the reference's surface (cutoff 44)
#: and LoRA (path B): blocks 0-43 on the serving kernels — every
#: L@1024 launch but those of blocks 44-47 (the q-pool block 44's tiled
#: route and the 3 stage-4 windows) and of the refinement head — and no
#: backward kernel (the trainable blocks' windows hold at most 256
#: tokens). The shipped segmenter's fine-tune (path C, t@512 float32,
#: whole-tree): no kernel (the global blocks hold 1024 tokens, under
#: FLASH_MIN_SEQ).
EXPECTED["train-whole"] = {**{k: 0 for k in EXPECTED["t@512"]},
                           **{k: 3 for k in TRAIN_KERNELS}}
EXPECTED["train-lcut"] = {**{k: 0 for k in EXPECTED["t@512"]},
                          **{k: 1 for k in TRAIN_KERNELS}}
EXPECTED["train-selective"] = {**{k: 0 for k in EXPECTED["t@512"]},
                               "mlp_block": 44, "window_attn_block": 7, "qpool_attn_block": 2,
                               "ln_qkv": 35, "flash_attn": 35, "attn_proj_residual": 35,
                               "window_attn_block.tiled": 32}
EXPECTED["train-lora"] = EXPECTED["train-selective"]
EXPECTED["train-c"] = {k: 0 for k in EXPECTED["t@512"]}
#: L_CUT (tests/test_torch_port_large.py): Hiera-L@1024 cut to stages
#: (1, 1, 3, 2), one global block of 4096 tokens (block 4)
L_CUT = dict(stages=[1, 1, 3, 2], global_att_blocks=[4])
#: timed steps after one warm-up, all on one batch (paths A and B); the
#: batches of path C; card against CPU gradients per leaf:
#: max |card − cpu| ≤ TRAIN_RTOL · max(1, max |cpu|) (as F32_PATH_RTOL)
TRAIN_STEPS, TRAIN_C_STEPS, TRAIN_RTOL = 5, 4, 1e-3
#: the trained product: the first PRODUCT_IMAGES eval images (sorted, as
#: scripts/bench_trained_product.py takes them), two of them for the card
#: against CPU check, chunks of PRODUCT_BATCH for analyze_many, timed runs
PRODUCT_IMAGES, PRODUCT_BATCH, PRODUCT_RUNS = 16, 8, 3
PRODUCT_PARITY = ("ac_rc", "series_rl")
#: the serving phase: client threads, and timed rounds of every image
#: after one warm-up round
SERVE_CLIENTS, SERVE_ROUNDS = 8, 5
#: its bf16 trunk on the card against its float32 trunk on the CPU, per
#: stage output: max |card − cpu| ≤ 2^-4 · max |cpu| and rms(card − cpu)
#: ≤ 2^-5 · rms(cpu). bf16 keeps 8 significant bits; the port's own bf16
#: trunk on the CPU, whose roundings the kernels share, differs from its
#: f32 trunk by up to 1.8 % of max |ref| and 1.3 % rms at this layout
#: (hd 64 and 32, resolution 256)
OFF_PRESET_MAX, OFF_PRESET_RMS = 2.0 ** -4, 2.0 ** -5
#: ms of each timed analyze() by path (timed_runs), for the FLOP rates,
#: and each run's stage split
ANALYZE_MS: dict = {}
ANALYZE_STAGES: dict = {}
#: the web UI phase: timed rounds of POSTs of every upload after a warm-up
WEB_ROUNDS = 2
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
    """Eager ms a call: `iters` calls between two events, so each call's
    Python, checks, allocation and ctypes dispatch are in the time."""
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


def graph_ms(fn, iters=20, replays=5):
    """Device ms a call: `iters` calls captured in one CUDA graph (the
    wrappers launch on the current stream, the capture stream, and their
    torch.empty draws from the graph's pool), its replays timed between
    events, divided by the calls. No host dispatch is in the time, only
    the card's own launch of each kernel (the launch-floor row)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def launch_floor(smi):
    """The launch-floor row: the empty kernel of csrc/launch_floor.cu timed
    as every kernel row is, device (graph replay) and eager."""
    from circuitvision_tpu_torch.ops.cuda.build import empty_kernel

    row = {"launch_floor": {"source": "circuitvision_tpu_torch/csrc/launch_floor.cu",
                            "ms": graph_ms(empty_kernel, iters=100),
                            "eager_ms": cuda_ms(empty_kernel, iters=100), "card": smi}}
    print(json.dumps(row), flush=True)
    return row["launch_floor"]


def counters():
    """(reset, read) over every kernel's launch count and the window and
    q-pool wrappers' tiled-route counts."""
    from circuitvision_tpu_torch.ops.cuda import flash_attn as fa
    from circuitvision_tpu_torch.ops.cuda import fused_ln as fl
    from circuitvision_tpu_torch.ops.cuda import global_attn as ga
    from circuitvision_tpu_torch.ops.cuda import mlp_block as mb
    from circuitvision_tpu_torch.ops.cuda import morphology as mo
    from circuitvision_tpu_torch.ops.cuda import refinement as rf
    from circuitvision_tpu_torch.ops.cuda import window_attn as wa

    fns = {"mlp_block": mb.mlp_block, "window_attn_block": wa.window_attn_block,
           "qpool_attn_block": wa.qpool_attn_block, "refinement": rf.refinement,
           "ln_qkv": ga.ln_qkv, "flash_attn": fa.flash_attn,
           "attn_proj_residual": ga.attn_proj_residual,
           "enhance_lines_fused": mo.enhance_lines_fused,
           "fused_layernorm": fl.fused_layernorm, "fused_add_layernorm": fl.fused_add_layernorm,
           **{k: getattr(fa, k) for k in TRAIN_KERNELS}}
    tiled = {"window_attn_block.tiled": wa.window_attn_block,
             "qpool_attn_block.tiled": wa.qpool_attn_block}

    def reset():
        for fn in fns.values():
            fn.launches = 0
        for fn in tiled.values():
            fn.tiled = 0

    def read():
        return {**{k: fn.launches for k, fn in fns.items()},
                **{k: fn.tiled for k, fn in tiled.items()}}

    return reset, read


def case_builders(torch):
    """Builders of kernel cases: each returns make(dtype, gen), which draws
    the operands and returns a dict of the kernel and plain calls, the
    tiled route where one exists, the bytes and FLOPs of one call, the
    dtype of its arithmetic, and the library call timed beside it where
    PyTorch has one."""
    import torch.nn.functional as F

    from circuitvision_tpu_torch.ops.cuda import flash_attn as fa
    from circuitvision_tpu_torch.ops.cuda import fused_ln as fl
    from circuitvision_tpu_torch.ops.cuda import global_attn as ga
    from circuitvision_tpu_torch.ops.cuda import mlp_block as mb
    from circuitvision_tpu_torch.ops.cuda import morphology as mo
    from circuitvision_tpu_torch.ops.cuda import refinement as rf
    from circuitvision_tpu_torch.ops.cuda import window_attn as wa

    F32 = torch.float32  # LayerNorm scale and bias are float32 for either dtype

    def rnd(gen, dt, *shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dt)

    def size(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def linears(dt, calls, note="sum of its products' F.linear calls (cuBLAS float32, TF32 off)"):
        """The float32 rows' yardstick: cuBLAS's float32 products (TF32
        off) of the kernel's function, one F.linear each, their device
        times summed."""
        if dt != torch.float32:
            return {}
        return dict(linears=calls, library_note=note)

    def mlp(t, c):
        def make(dt, gen):
            h = 4 * c
            args = (rnd(gen, dt, t, c), 1 + rnd(gen, F32, c, scale=0.1), rnd(gen, F32, c, scale=0.1),
                    rnd(gen, dt, h, c, scale=c ** -0.5), rnd(gen, dt, h, scale=0.02),
                    rnd(gen, dt, c, h, scale=h ** -0.5), rnd(gen, dt, c, scale=0.02))
            xn = mb.layernorm_f32(*args[:3], 1e-6).to(dt)
            hid = F.gelu(F.linear(xn, args[3], args[4]))
            return dict(kernel=lambda: mb.mlp_block(*args), plain=lambda: mb.mlp_block_plain(*args),
                        plan=mb.mlp_plan(t, c, h), width=c,
                        bytes=size(*args, args[0]), flops=4 * t * c * h, math_dt=dt,
                        **linears(dt, [lambda: F.linear(xn, args[3], args[4]),
                                       lambda: F.linear(hid, args[5], args[6])]))
        return make

    def window(nw, t, c, heads):
        def make(dt, gen):
            args = (rnd(gen, dt, nw, t, c), 1 + rnd(gen, F32, c, scale=0.1), rnd(gen, F32, c, scale=0.1),
                    rnd(gen, dt, 3 * c, c, scale=c ** -0.5), rnd(gen, dt, 3 * c, scale=0.02),
                    rnd(gen, dt, c, c, scale=c ** -0.5), rnd(gen, dt, c, scale=0.02))
            flops = nw * (2 * t * c * 3 * c + 4 * t * t * c + 2 * t * c * c)
            xn = mb.layernorm_f32(*args[:3], 1e-6).to(dt)
            q, k, v = (a.contiguous() for a in F.linear(xn, args[3], args[4]).view(
                nw, t, 3, heads, c // heads).permute(2, 0, 3, 1, 4))
            o = rnd(gen, dt, nw, t, c)  # the attention output's shape
            return dict(kernel=lambda: wa.window_attn_block(*args, heads=heads),
                        plain=lambda: wa.window_attn_block_plain(*args, heads=heads),
                        tiled=lambda: wa.window_attn_block_tiled(*args, heads=heads),
                        bytes=size(*args, args[0]), flops=flops, math_dt=dt,
                        **linears(dt, [lambda: F.linear(xn, args[3], args[4]),
                                       lambda: F.scaled_dot_product_attention(q, k, v),
                                       lambda: F.linear(o, args[5], args[6])],
                                  note="sum of its q|k|v and proj F.linear calls and "
                                       "F.scaled_dot_product_attention on the same q, k, v "
                                       "(float32, TF32 off)"))
        return make

    def qpool(nw, win, ci, co, heads):
        def make(dt, gen):
            t = win * win
            args = (rnd(gen, dt, nw * t, ci), 1 + rnd(gen, F32, ci, scale=0.1), rnd(gen, F32, ci, scale=0.1),
                    rnd(gen, dt, co, ci, scale=ci ** -0.5), rnd(gen, dt, co, scale=0.02),
                    rnd(gen, dt, 3 * co, ci, scale=ci ** -0.5), rnd(gen, dt, 3 * co, scale=0.02),
                    rnd(gen, dt, co, co, scale=co ** -0.5), rnd(gen, dt, co, scale=0.02))
            flops = nw * (2 * t * ci * co + 2 * t * ci * 3 * co + 4 * (t // 4) * t * co
                          + 2 * (t // 4) * co * co)
            kw = dict(heads=heads, win=win)
            xn = mb.layernorm_f32(*args[:3], 1e-6).to(dt)
            o = rnd(gen, dt, nw * t // 4, co)  # the attention output's shape
            return dict(kernel=lambda: wa.qpool_attn_block(*args, **kw),
                        plain=lambda: wa.qpool_attn_block_plain(*args, **kw),
                        tiled=lambda: wa.qpool_attn_block_tiled(*args, **kw),
                        bytes=size(*args) + nw * t // 4 * co * args[0].element_size(),
                        flops=flops, math_dt=dt,
                        **linears(dt, [lambda: F.linear(xn, args[3], args[4]),
                                       lambda: F.linear(xn, args[5], args[6]),
                                       lambda: F.linear(o, args[7], args[8])]))
        return make

    def refine(h, w):
        def make(dt, gen):
            ws = [rnd(gen, dt, 4, 1, k, k, scale=k ** -1.0) for k in rf.KERNELS]
            bs = [rnd(gen, dt, 4, scale=0.1) for _ in rf.KERNELS]
            args = (rnd(gen, dt, 1, h, w, 1, scale=3.0), ws, bs, rnd(gen, dt, 1, 16, 1, 1, scale=0.25),
                    rnd(gen, dt, 1, scale=0.1))
            flops = h * w * (2 * 4 * sum(k * k for k in rf.KERNELS) + 2 * 16)
            # the head's arithmetic is float32 whatever the logits' dtype
            return dict(kernel=lambda: rf.refinement(*args), plain=lambda: rf.refinement_plain(*args),
                        bytes=size(args[0]) + h * w * 4, flops=flops, math_dt=torch.float32)
        return make

    def ln_qkv(b, n, ci, co, heads, slabs):
        def make(dt, gen):
            n_out = slabs * co
            args = (rnd(gen, dt, b, n, ci), 1 + rnd(gen, F32, ci, scale=0.1), rnd(gen, F32, ci, scale=0.1),
                    rnd(gen, dt, n_out, ci, scale=ci ** -0.5), rnd(gen, dt, n_out, scale=0.02))
            # cuBLAS's product alone, on the input already normalised: how
            # far the kernel's GEMM is from a library GEMM (not its library
            # time: no call does LN + product)
            xn = mb.layernorm_f32(*args[:3], 1e-6).to(dt)
            return dict(kernel=lambda: ga.ln_qkv(*args, heads, slabs),
                        plain=lambda: ga.ln_qkv_plain(*args, heads, slabs),
                        plan=ga.ln_qkv_plan(b * n, ci, n_out), width=ci,
                        linear=lambda: F.linear(xn, args[3], args[4]),
                        library_note="no call does LN + product",
                        bytes=size(*args) + b * n * n_out * args[0].element_size(),
                        flops=2 * b * n * ci * n_out, math_dt=dt)
        return make

    def flash(b, h, nq_in, nk, hd, pool_win=0):
        def make(dt, gen):
            q, k, v = (rnd(gen, dt, b, h, n, hd) for n in (nq_in, nk, nk))
            # SDPA gets q already pooled: the pool is not its work
            q_lib = ga.pool2x2_windows(q, pool_win) if pool_win else q
            nq = q_lib.shape[2]
            return dict(kernel=lambda: fa.flash_attn(q, k, v, pool_win),
                        plain=lambda: fa.flash_attn_plain(q, k, v, pool_win),
                        plan=fa.flash_plan(b * h, nq, nk, hd),
                        library=lambda: F.scaled_dot_product_attention(q_lib, k, v),
                        bytes=size(q, k, v) + b * h * nq * hd * q.element_size(),
                        flops=4 * b * h * nq * nk * hd, math_dt=dt)
        return make

    def proj(b, n, c, heads, pool_win=0, round_proj=False):
        def make(dt, gen):
            rows = pool_win * pool_win if pool_win else n
            args = (rnd(gen, dt, b, rows, c), rnd(gen, dt, b, heads, n, c // heads),
                    rnd(gen, dt, c, c, scale=c ** -0.5), rnd(gen, dt, c, scale=0.02))
            kw = dict(pool_win=pool_win, round_proj=round_proj)
            # cuBLAS's product alone, with its bias, over the heads already
            # concatenated: how far the kernel's GEMM is from a library
            # GEMM (not its library time: no call does head gather +
            # product + residual)
            a_cat = args[1].permute(0, 2, 1, 3).reshape(b, n, c).contiguous()
            return dict(kernel=lambda: ga.attn_proj_residual(*args, **kw),
                        plain=lambda: ga.attn_proj_residual_plain(*args, **kw),
                        plan=ga.proj_res_plan(b * n, c),
                        linear=lambda: F.linear(a_cat, args[2], args[3]),
                        library_note="no call does head gather + product + residual",
                        bytes=size(*args) + b * n * c * args[0].element_size(),
                        flops=2 * b * n * c * c, math_dt=dt)
        return make

    def morph(h, w):
        def make(dt, gen):
            # a line raster at the drawings' stroke density, with grey levels
            x = torch.round(torch.rand(h, w, generator=gen, device="cuda") * 255)
            x = torch.where(torch.rand(h, w, generator=gen, device="cuda") < 0.9, 0.0, x)
            return dict(kernel=lambda: mo.enhance_lines_fused(x),
                        plain=lambda: mo.enhance_lines_fused_plain(x),
                        library_note="no single call does blur + round + dilate + erode",
                        bytes=2 * h * w * 4, flops=MORPH_OPS_PER_PIXEL * h * w, math_dt=F32,
                        exact=True)
        return make

    def layernorm(t, c):
        def make(dt, gen):
            x = rnd(gen, dt, t, c, scale=2.0)
            s, b = 1 + rnd(gen, F32, c, scale=0.1), rnd(gen, F32, c, scale=0.1)
            sd, bd = s.to(dt), b.to(dt)
            return dict(kernel=lambda: fl.fused_layernorm(x, s, b),
                        plain=lambda: fl.fused_layernorm_plain(x, s, b),
                        library=lambda: F.layer_norm(x, (c,), sd, bd, 1e-6),
                        bytes=size(x, x, s, b), flops=LN_OPS_PER_ELEMENT * t * c, math_dt=F32)
        return make

    def add_layernorm(t, c):
        def make(dt, gen):
            a, r = rnd(gen, dt, t, c, scale=2.0), rnd(gen, dt, t, c)
            s, b = 1 + rnd(gen, F32, c, scale=0.1), rnd(gen, F32, c, scale=0.1)
            return dict(kernel=lambda: fl.fused_add_layernorm(r, a, s, b),
                        plain=lambda: fl.fused_add_layernorm_plain(r, a, s, b),
                        library_note="no single call does add + LN",
                        bytes=size(a, r, a, a, s, b), flops=(LN_OPS_PER_ELEMENT + 1) * t * c,
                        math_dt=F32)
        return make

    def attn_grad(b, h, n, hd, part):
        """FlashAttention's kernels at b × h heads of n tokens: the lse
        forward ("lse"), the dq kernel ("dq", which also returns delta) or
        the dkv kernel ("dkv"); o, lse and delta from the plain forward,
        the same for the kernel and its plain version. Their library
        yardstick: SDPA, and for the backward SDPA's backward through
        autograd (dq, dk and dv in one call), on the device clock as the
        kernels are: forward and backward replayed in one CUDA graph, less
        the forward replayed in another."""
        def make(dt, gen):
            q, k, v, do = (rnd(gen, dt, b, h, n, hd) for _ in range(4))
            elems, es = b * h * n * hd, q.element_size()
            if part == "lse":
                return dict(kernel=lambda: fa.flash_attn_lse(q, k, v),
                            plain=lambda: fa.flash_attn_lse_plain(q, k, v), parts=True,
                            library=lambda: F.scaled_dot_product_attention(q, k, v),
                            bytes=4 * elems * es + b * h * n * 4, flops=4 * b * h * n * n * hd,
                            math_dt=dt, timing=dict(iters=5, replays=3))
            o, lse = fa.flash_attn_lse_plain(q, k, v)
            delta = (do.float() * o.float()).sum(-1)
            ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
            common = dict(parts=True, math_dt=dt, timing=dict(iters=5, replays=3),
                          library=lambda: torch.autograd.grad(
                              F.scaled_dot_product_attention(ql, kl, vl), (ql, kl, vl), do),
                          library_less=lambda: F.scaled_dot_product_attention(ql, kl, vl),
                          library_note="SDPA's backward: SDPA's forward and its backward "
                                       "through autograd (dq, dk and dv) replayed in one CUDA "
                                       "graph, less the forward replayed in another")
            if part == "dq":
                return dict(kernel=lambda: fa.flash_attn_bwd_dq(q, k, v, o, lse, do),
                            plain=lambda: (fa.flash_attn_bwd_plain(q, k, v, o, lse, do)[0], delta),
                            bytes=6 * elems * es + 2 * b * h * n * 4,
                            flops=6 * b * h * n * n * hd, **common)
            return dict(kernel=lambda: fa.flash_attn_bwd_dkv(q, k, v, lse, delta, do),
                        plain=lambda: fa.flash_attn_bwd_plain(q, k, v, o, lse, do)[1:],
                        bytes=6 * elems * es + 2 * b * h * n * 4, flops=8 * b * h * n * n * hd,
                        **common)
        return make

    return dict(mlp=mlp, window=window, qpool=qpool, refine=refine, ln_qkv=ln_qkv, flash=flash,
                proj=proj, morph=morph, layernorm=layernorm, add_layernorm=add_layernorm,
                attn_grad=attn_grad)


def kernel_cases(torch, path, raster_counts=None):
    """(name, shape label, launches on the path, make) for every shape the
    `path` launches each kernel with: per analyze() on "t@512" and
    "l@1024", per run of the trunk LayerNorm option on "trunk-ln", and on
    "batch" per analyze_many() of the drawn topology at the raster shapes
    it recorded (`raster_counts` = ({(h, w): launches} of that run, the
    shapes of the seeded-weight run), those of the seeded-weight run and
    three more shapes as rows off the count."""
    b = case_builders(torch)
    if path in ("train", "train-t"):
        # per whole-tree step at batch 1: L@1024's global blocks 23, 33, 43
        # (8 heads of 72), t@1024's 5, 7, 9 (4 heads of 96)
        heads, hd = (8, 72) if path == "train" else (4, 96)
        return [(name, f"global 1x{heads} heads N=4096 D={hd}", 3,
                 b["attn_grad"](1, heads, 4096, hd, part))
                for name, part in (("flash_attn_lse", "lse"), ("flash_attn_bwd_dq", "dq"),
                                   ("flash_attn_bwd_dkv", "dkv"))]
    if path == "trunk-ln":
        return [(n, f"T={t} C={c}", 1, b[k](t, c)) for t, c in L_TRUNK_ROWS
                for n, k in (("fused_layernorm", "layernorm"),
                             ("fused_add_layernorm", "add_layernorm"))]
    if path == "batch":
        drawn, seeded = raster_counts
        # and a 1×1 raster: the kernel's own fixed cost beside the launch floor
        rows = {(600, 800): (0, "off the path"), (600, 1003): (0, "off the path"),
                (1, 1): (0, "off the path")}
        rows.update({hw: (0, "seeded-weight crop") for hw in seeded})
        rows.update({hw: (n, "drawn topology") for hw, n in drawn.items()})
        return [("enhance_lines_fused", f"{h}x{w} {what}", n, b["morph"](h, w))
                for (h, w), (n, what) in rows.items()]
    if path == "t@512":
        return [
            ("mlp_block", "T=16384 C=96", 1, b["mlp"](16384, 96)),
            ("mlp_block", "T=4096 C=192", 2, b["mlp"](4096, 192)),
            ("mlp_block", "T=1024 C=384", 7, b["mlp"](1024, 384)),
            ("mlp_block", "T=256 C=768", 2, b["mlp"](256, 768)),
            ("window_attn_block", "256 windows x 64 tokens C=96 heads=1", 1, b["window"](256, 64, 96, 1)),
            ("window_attn_block", "256 windows x 16 tokens C=192 heads=2", 1, b["window"](256, 16, 192, 2)),
            ("qpool_attn_block", "256 windows win=8 C=96->192 heads=2", 1, b["qpool"](256, 8, 96, 192, 2)),
            ("qpool_attn_block", "256 windows win=4 C=192->384 heads=4", 1, b["qpool"](256, 4, 192, 384, 4)),
            ("refinement", "1x512x512", 1, b["refine"](512, 512)),
        ]
    return [
        ("mlp_block", "T=65536 C=144", 2, b["mlp"](65536, 144)),
        ("mlp_block", "T=16384 C=288", 6, b["mlp"](16384, 288)),
        ("mlp_block", "T=4096 C=576", 36, b["mlp"](4096, 576)),
        ("mlp_block", "T=1024 C=1152", 4, b["mlp"](1024, 1152)),
        ("window_attn_block", "1024 windows x 64 tokens C=144 heads=2", 2, b["window"](1024, 64, 144, 2)),
        ("window_attn_block", "1024 windows x 16 tokens C=288 heads=4", 5, b["window"](1024, 16, 288, 4)),
        ("qpool_attn_block", "1024 windows win=8 C=144->288 heads=4", 1, b["qpool"](1024, 8, 144, 288, 4)),
        ("qpool_attn_block", "1024 windows win=4 C=288->576 heads=8", 1, b["qpool"](1024, 4, 288, 576, 8)),
        ("refinement", "1x1024x1024", 1, b["refine"](1024, 1024)),
        ("ln_qkv", "global 1x4096 C=576 heads=8", 3, b["ln_qkv"](1, 4096, 576, 576, 8, 3)),
        ("ln_qkv", "16 windows x 256 C=576 heads=8", 32, b["ln_qkv"](16, 256, 576, 576, 8, 3)),
        ("ln_qkv", "16 windows x 64 C=1152 heads=16", 3, b["ln_qkv"](16, 64, 1152, 1152, 16, 3)),
        ("ln_qkv", "q-pool 1024 windows x 64 C=144->288 qkv (tiled route)", 0,
         b["ln_qkv"](1024, 64, 144, 288, 4, 3)),
        ("ln_qkv", "q-pool 1024 windows x 64 C=144->288 shortcut (tiled route)", 0,
         b["ln_qkv"](1024, 64, 144, 288, 1, 1)),
        ("ln_qkv", "q-pool 16 windows x 256 C=576->1152 qkv", 1, b["ln_qkv"](16, 256, 576, 1152, 16, 3)),
        ("ln_qkv", "q-pool 16 windows x 256 C=576->1152 shortcut", 1,
         b["ln_qkv"](16, 256, 576, 1152, 1, 1)),
        ("flash_attn", "global 1x8 heads N=4096 D=72", 3, b["flash"](1, 8, 4096, 4096, 72)),
        ("flash_attn", "16 windows x 8 heads N=256 D=72", 32, b["flash"](16, 8, 256, 256, 72)),
        ("flash_attn", "16 windows x 16 heads N=64 D=72", 3, b["flash"](16, 16, 64, 64, 72)),
        ("flash_attn", "q-pool 1024 windows x 4 heads Nq=16 Nk=64 D=72 (tiled route)", 0,
         b["flash"](1024, 4, 64, 64, 72, pool_win=8)),
        ("flash_attn", "q-pool 16 windows x 16 heads Nq=64 Nk=256 D=72", 1,
         b["flash"](16, 16, 256, 256, 72, pool_win=16)),
        ("attn_proj_residual", "global 1x4096 C=576 heads=8", 3, b["proj"](1, 4096, 576, 8)),
        ("attn_proj_residual", "16 windows x 256 C=576 heads=8", 32,
         b["proj"](16, 256, 576, 8, round_proj=True)),
        ("attn_proj_residual", "16 windows x 64 C=1152 heads=16", 3,
         b["proj"](16, 64, 1152, 16, round_proj=True)),
        ("attn_proj_residual", "q-pool 1024 windows x 16 C=288 heads=4 (tiled route)", 0,
         b["proj"](1024, 16, 288, 4, pool_win=8, round_proj=True)),
        ("attn_proj_residual", "q-pool 16 windows x 64 C=1152 heads=16", 1,
         b["proj"](16, 64, 1152, 16, pool_win=16, round_proj=True)),
    ]


def run_kernels(torch, path, raster_counts=None):
    """Kernel phases: every case against its plain version, timed on the
    device (`graph_ms`: kernel_ms, library_ms, linear_ms, and the rate and
    sums from them) and eagerly (`cuda_ms`: eager_ms, plain_ms). Returns
    per-kernel sums over the path's launches in the path's dtype (bfloat16;
    float32 for the line enhancement, which takes only float32) and the
    worst error seen in either dtype."""
    summary = {}
    for name, label, count, make in kernel_cases(torch, path, raster_counts):
        dts = ("float32",) if name == "enhance_lines_fused" else ("bfloat16", "float32")
        for dt_name in dts:
            dt = getattr(torch, dt_name)
            gen = torch.Generator(device="cuda").manual_seed(0)
            case = make(dt, gen)
            out = case["kernel"]()
            ref = case["plain"]()
            if isinstance(out, tuple) and not case.get("parts"):
                # fused_add_layernorm: the sum must be bit-exact
                if not torch.equal(out[0], ref[0]):
                    raise AssertionError(f"{name} [{path} {label}, {dt_name}]: residual sum differs")
                out, ref = out[1], ref[1]
            torch.cuda.synchronize()
            # each output held to the tolerance of the dtype it is stored in
            # (the refinement head returns float32 whatever its input's
            # dtype, FlashAttention's lse and delta are float32); the line
            # enhancement must be bit-exact. The row shows the output
            # nearest its tolerance.
            err, tol, worst = 0.0, 0.0, -1.0
            for o_, r_ in (zip(out, ref) if case.get("parts") else [(out, ref)]):
                got, want = o_.float(), r_.float()
                e = float((got - want).abs().max())
                t = 0.0 if case.get("exact") else \
                    tolerance(str(o_.dtype).removeprefix("torch."), float(want.abs().max()))
                if not torch.isfinite(got).all() or e > t:
                    raise AssertionError(f"{name} [{path} {label}, {dt_name}]: max |kernel - "
                                         f"plain| {e:.3e} > tol {t:.3e}")
                if (e / t if t else 0.0) > worst:
                    err, tol, worst = e, t, (e / t if t else 0.0)
            timing = case.get("timing", {})
            k_ms = graph_ms(case["kernel"], **timing)
            eager_ms = cuda_ms(case["kernel"], iters=timing.get("iters", 20))
            p_ms = cuda_ms(case["plain"], iters=5)
            lib_ms = None
            if case.get("library"):
                lib_ms = graph_ms(case["library"], **timing)
                if case.get("library_less"):  # a part of the call that is not the function
                    lib_ms -= graph_ms(case["library_less"], **timing)
            if case.get("linears"):
                lib_ms = sum(graph_ms(f) for f in case["linears"])
            t_bytes = case["bytes"] / HBM_BYTES_PER_S * 1e3
            math = str(case["math_dt"]).removeprefix("torch.")
            t_fma = t_ops = case["flops"] / PEAK_FLOPS[math] * 1e3
            tf32x3 = math == "float32" and name in TF32X3_KERNELS
            if tf32x3:  # three TF32 products on the tensor cores for each
                t_ops = 3 * case["flops"] / PEAK_FLOPS["tf32"] * 1e3
            row = {"kernel": name, "path": path, "shape": label, "dtype": dt_name,
                   "max_abs_err": err, "tol": tol, "kernel_ms": k_ms, "eager_ms": eager_ms,
                   "plain_ms": p_ms,
                   "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else
                   "3xTF32 operations" if tf32x3 else "operations",
                   "launches_on_path": count}
            if tf32x3:
                row["fma_bound_ms"] = max(t_bytes, t_fma)
            if case.get("library_note") and case.get("linears"):
                row["library_note"] = case["library_note"]
            if name in TFLOPS_ROWS:
                row["tflops"] = case["flops"] / (k_ms * 1e-3) / 1e12
            if case.get("linear"):
                row["linear_ms"] = graph_ms(case["linear"])
            print(json.dumps(row), flush=True)
            s = summary.setdefault(name, {"ms": 0.0, "eager_ms": 0.0, "plain_ms": 0.0,
                                          "bound_ms": 0.0,
                                          "library_ms": None, "t_bytes": 0.0, "t_ops": 0.0,
                                          "max_abs_err": 0.0,
                                          "library_note": None if case.get("linears")
                                          else case.get("library_note")})
            if dt_name == dts[0]:
                s["ms"] += count * k_ms
                s["eager_ms"] += count * eager_ms
                s["plain_ms"] += count * p_ms
                s["bound_ms"] += count * row["bound_ms"]
                s["t_bytes"] += count * t_bytes
                s["t_ops"] += count * t_ops
                if lib_ms is not None:
                    s["library_ms"] = (s["library_ms"] or 0.0) + count * lib_ms
            if dt_name == "float32" and len(dts) > 1:  # the float32 instances' sums
                f = s.setdefault("f32", {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                         "fma_bound_ms": 0.0, "library_ms": None,
                                         "bound_by": row["bound_by"], "max_abs_err": 0.0})
                f["ms"] += count * k_ms
                f["plain_ms"] += count * p_ms
                f["bound_ms"] += count * row["bound_ms"]
                f["fma_bound_ms"] += count * row.get("fma_bound_ms", row["bound_ms"])
                if lib_ms is not None:
                    f["library_ms"] = (f["library_ms"] or 0.0) + count * lib_ms
                f["max_abs_err"] = max(f["max_abs_err"], err)
            s["max_abs_err"] = max(s["max_abs_err"], err)
    return summary


def check_plans(torch):
    """The bf16 launch plans of flash_attn, mlp_block, ln_qkv and
    attn_proj_residual against the kernels' own shared-memory sizes, at
    every shape of both paths."""
    from circuitvision_tpu_torch.ops.cuda import flash_attn as fa
    from circuitvision_tpu_torch.ops.cuda import mlp_block as mb
    from circuitvision_tpu_torch.ops.cuda.build import library

    fl, ml, gl = library("flash_attn"), library("mlp_block"), library("global_attn")
    for name, label, _count, make in kernel_cases(torch, "t@512") + kernel_cases(torch, "l@1024"):
        if name not in ("flash_attn", "mlp_block", "ln_qkv", "attn_proj_residual"):
            continue
        case = make(torch.bfloat16, torch.Generator(device="cuda").manual_seed(0))
        plan = case["plan"]
        if name == "flash_attn":
            ok = fl.cv_flash_attn_bf16_smem(plan.width, plan.mt, plan.wpp, plan.stages) == plan.smem
        elif name == "ln_qkv":
            ok = gl.cv_ln_heads_ln_smem(case["width"]) == plan.ln_smem and \
                gl.cv_ln_heads_gemm_smem(plan.gemm.bm) == plan.gemm.smem
        elif name == "attn_proj_residual":  # ln_qkv's GEMM kernel, its own plan
            ok = gl.cv_ln_heads_gemm_smem(plan.bm) == plan.smem
        else:
            ok = ml.cv_mlp_ln_smem(case["width"]) == plan.ln_smem and all(
                ml.cv_mlp_gemm_smem(g.bm) == g.smem for g in (plan.gemm1, plan.gemm2))
        if not ok:
            raise AssertionError(f"{name} plan disagrees with the kernel at {label}")
    bl = library("flash_bwd")
    for hd in range(8, fa.LSE_WIDTHS[-1] + 1, 8):  # FlashAttention's bf16 backward
        if bl.cv_flash_bwd_bf16_smem(hd) != fa.flash_bwd_tc_smem(fa.grad_width(hd)):
            raise AssertionError(f"flash_bwd plan disagrees with the kernels at head width {hd}")
    print(json.dumps({"plans_match_kernels": True, "flash_widths": list(fa.TC_WIDTHS),
                      "flash_grad_widths": list(fa.LSE_WIDTHS),
                      "gemm_rows": list(mb.GEMM_ROWS)}), flush=True)


def run_routes(torch):
    """Phase 5, second half: the window and q-pool blocks at every L@1024
    shape through both routes — the one-block kernel where a window fits
    its shared memory, and the tiled route everywhere — against the plain
    block; and the route rule against the kernels' own sizes."""
    from circuitvision_tpu_torch.ops.cuda.build import library
    from circuitvision_tpu_torch.ops.cuda.window_attn import (
        TC_HEAD_WIDTHS, qpool_attn_f32_smem, window_attn_f32_smem, window_route, window_smem,
    )

    check_plans(torch)
    lib = library("window_attn")
    # the float32 window and q-pool blocks' attention blocks (their GEMM's
    # below, as window_smem)
    for hd in TC_HEAD_WIDTHS:
        if lib.cv_qpool_f32_attn_smem(hd) != qpool_attn_f32_smem(hd):
            raise AssertionError(f"qpool_attn_f32_smem disagrees with the kernel at head width {hd}")
        if lib.cv_window_f32_attn_smem(hd) != window_attn_f32_smem(hd):
            raise AssertionError(f"window_attn_f32_smem disagrees with the kernel at head width {hd}")
    for t, c in [(64, 96), (16, 192)] + [(t, c) for _nw, t, c, _h in L_WINDOWS]:
        for code, dt in enumerate((torch.float32, torch.bfloat16)):
            if lib.cv_window_attn_smem(t, c, code) != window_smem("window", t, c, c, dt):
                raise AssertionError(f"window_smem disagrees with the kernel at T={t} C={c} {dt}")
    for win, ci, co in [(8, 96, 192), (4, 192, 384)] + [(w, ci, co) for _n, w, ci, co, _h in L_QPOOLS]:
        for code, dt in enumerate((torch.float32, torch.bfloat16)):
            if lib.cv_qpool_attn_smem(win, ci, co, code) != window_smem("qpool", win * win, ci, co, dt):
                raise AssertionError(f"qpool smem disagrees with the kernel at win={win} "
                                     f"{ci}->{co} {dt}")
    b = case_builders(torch)
    cases = [("window_attn_block", f"{nw} windows x {t} tokens C={c} heads={h}",
              ("window", t, c, c, h), b["window"](nw, t, c, h)) for nw, t, c, h in L_WINDOWS]
    cases += [("qpool_attn_block", f"{nw} windows win={w} C={ci}->{co} heads={h}",
               ("qpool", w * w, ci, co, h), b["qpool"](nw, w, ci, co, h))
              for nw, w, ci, co, h in L_QPOOLS]
    for name, label, shape, make in cases:
        for dt_name in ("bfloat16", "float32"):
            route = window_route(*shape, getattr(torch, dt_name))
            gen = torch.Generator(device="cuda").manual_seed(0)
            case = make(getattr(torch, dt_name), gen)
            ref = case["plain"]().float()
            tol = tolerance(dt_name, float(ref.abs().max()))
            row = {"route_check": name, "shape": label, "dtype": dt_name, "route": route,
                   "tol": tol, "plain_ms": cuda_ms(case["plain"], iters=5)}
            runs = {"tiled": case["tiled"]}
            if route == "block":
                runs["block"] = case["kernel"]
            for which, fn in runs.items():
                got = fn().float()
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                if not torch.isfinite(got).all() or err > tol:
                    raise AssertionError(f"{name} [{label}, {dt_name}, {which} route]: "
                                         f"max |route - plain| {err:.3e} > tol {tol:.3e}")
                row[f"{which}_err"], row[f"{which}_ms"] = err, graph_ms(fn)
            print(json.dumps(row), flush=True)


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


def batch_drawings():
    """The batched phase's drawings: BATCH_IMAGES seeds, sizes from 600×820
    to 705×970. On larger pages the crop's clusters part and it keeps part
    of the circuit, one node, in the JAX package as in the port
    (tests/test_torch_port_batch.py::test_large_drawings_crop_alike)."""
    return [draw_schematic(100 + i, h=600 + 7 * i, w=820 + 10 * i) for i in range(BATCH_IMAGES)]


def timed_runs(torch, analyzer, image, path):
    """One warm-up and three timed analyze() calls on the card, each with
    every launch count set to 0 just before it and read just after and
    held to EXPECTED[path]. Returns the counts."""
    reset, read = counters()
    t0 = time.perf_counter()
    analyzer.analyze(image)
    print(f"   warm-up analyze: {time.perf_counter() - t0:.3f} s", flush=True)
    for run in range(3):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = analyzer.analyze(image)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
        counts = read()
        ANALYZE_MS.setdefault(path, []).append(total_ms)
        stages = {k: round(v * 1e3, 3) for k, v in res.timings.timings.items()}
        ANALYZE_STAGES.setdefault(path, []).append(stages)
        print(json.dumps({"path": path, "analyze_run": run, "total_ms": total_ms,
                          "stages_ms": stages, "launches": counts,
                          "boxes": len(res.bboxes_orig_nms), "nodes": len(res.nodes)}), flush=True)
        if counts != EXPECTED[path]:
            raise AssertionError(f"{path}: launches per analyze {counts} != {EXPECTED[path]}")
        if res.sam_mask is None or res.sam_mask_display is None:
            raise AssertionError("SAM2 produced no mask")
        if res.node_mask is None:
            raise AssertionError("node analysis raised (see the log above)")
        if res.sam_mask.shape != res.image_for_analysis.shape[:2]:
            raise AssertionError("SAM2 mask shape differs from the analysed image")
    return counts


def describe(cfg):
    print(f"   config: YOLOv11-{cfg.detector.scale}@{cfg.detector.img_size} "
          f"({cfg.detector.num_classes} classes, {cfg.detector.dtype}) + SAM2 Hiera "
          f"embed {cfg.sam2.embed_dim} stages {tuple(cfg.sam2.stages)}@{cfg.sam2.resolution} "
          f"({cfg.sam2.dtype})", flush=True)


def path_err(torch, name, got, ref):
    """max |card − cpu| of a continuous output, held to F32_PATH_RTOL."""
    got, ref = got.float().cpu(), ref.float()
    err = float((got - ref).abs().max())
    tol = F32_PATH_RTOL * max(1.0, float(ref.abs().max()))
    if got.shape != ref.shape or not torch.isfinite(got).all() or err > tol:
        raise AssertionError(f"{name}: card vs cpu max |diff| {err:.3e} > tol {tol:.3e}")
    return {"max_abs_err": err, "tol": tol, "ref_max_abs": float(ref.abs().max())}


def run_main_path(torch):
    """Phase 4, t@512. Returns the launches of each kernel in one analyze()."""
    import numpy as np

    from circuitvision_tpu_torch.core.config import PipelineConfig
    from circuitvision_tpu_torch.core.types import BBox
    from circuitvision_tpu_torch.models.bridge import detector_config, sam2_config, seeded_state
    from circuitvision_tpu_torch.models.yolo.decode import STRIDES
    from circuitvision_tpu_torch.netlist.generate import (
        generate_netlist_from_nodes, stringify_netlist,
    )
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch
    from circuitvision_tpu_torch.topology.nodes import extract_nodes
    from circuitvision_tpu_torch.topology.reclassify import segment_classical

    ymeta = json.loads((REPO / "ckpt" / "yolo" / "meta.json").read_text())
    smeta = json.loads((REPO / "ckpt" / "sam2" / "meta.json").read_text())
    cfg = PipelineConfig(detector=detector_config(ymeta), sam2=sam2_config(smeta))
    describe(cfg)
    ystate, sstate = seeded_state("yolo", ymeta, 0), seeded_state("sam2", smeta, 1)
    image, drawn_boxes = draw_schematic(0)
    launches = timed_runs(torch, CircuitAnalyzerTorch(cfg, ystate, sstate, device="cuda"),
                          image, "t@512")

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
    g_heads, c_heads = card32.yolo_heads(image)[0], cpu32.yolo_heads(image)[0]
    continuous = {f"yolo_head_stride{s}": path_err(torch, f"YOLO head, stride {s}", g, c)
                  for s, g, c in zip(STRIDES, g_heads, c_heads)}
    continuous["sam2_logits"] = path_err(torch, "SAM2 logits", card32.segment_logits(image),
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


def run_l_path(torch):
    """Phase 6: analyze() at YOLOv11-s@640 + SAM2 Hiera-L@1024, the default
    SAM2Config (bfloat16), on seeded weights; then SAM2's logits in
    float32 on the card against the CPU at the full depth. Returns the
    launches of each kernel in one analyze()."""
    from circuitvision_tpu_torch.core.config import PipelineConfig
    from circuitvision_tpu_torch.models.bridge import detector_config, seeded_state
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch

    ymeta = json.loads((REPO / "ckpt" / "yolo" / "meta.json").read_text())
    cfg = PipelineConfig(detector=detector_config(ymeta))
    describe(cfg)
    ystate = seeded_state("yolo", ymeta, 0)
    sstate = seeded_state("sam2", {"sam2": {"preset": "l", "overrides": {}}}, 2)
    image, _boxes = draw_schematic(0)
    launches = timed_runs(torch, CircuitAnalyzerTorch(cfg, ystate, sstate, device="cuda"),
                          image, "l@1024")

    cfg32 = dataclasses.replace(cfg, sam2=dataclasses.replace(cfg.sam2, dtype="float32"))
    card32 = CircuitAnalyzerTorch(cfg32, ystate, sstate, device="cuda")
    cpu32 = CircuitAnalyzerTorch(cfg32, ystate, sstate, device="cpu")
    card32.segment_logits(image)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = card32.segment_logits(image)
    torch.cuda.synchronize()
    print(f"   card float32 SAM2-L@1024 logits: {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    ref = cpu32.segment_logits(image)
    print(f"   cpu float32 SAM2-L@1024 logits: {time.perf_counter() - t0:.3f} s", flush=True)
    print(json.dumps({"f32_card_vs_cpu_l1024": {
        "sam2_logits": path_err(torch, "SAM2-L logits", got, ref),
        "shape": list(ref.shape)}}), flush=True)
    return launches


#: the reference deployment's checkpoints: the PEFT adapters' alpha (the
#: reference fine-tune's), the standard deviation of their seeded A and B
#: (small enough that a fold moves a weight by a few per cent), and
#: video-memory entries of a real SAM2.1 checkpoint, which the image path
#: never reads
REF_LORA_ALPHA, REF_LORA_STD = 16.0, 0.01
REF_VIDEO_KEYS = {
    "sam2_model.base_model.model.memory_attention.layers.0.self_attn.q_proj.weight": (256, 256),
    "sam2_model.base_model.model.maskmem_tpos_enc": (7, 1, 1, 64),
    "sam2_model.base_model.model.no_mem_embed": (1, 1, 256),
}
REF_SEEDS = {"yolo": 20, "sam2": 21, "lora": 22}


def peft_reference(np, plain, inventory):
    """A torch-named SAM2 state dict as the reference fine-tune saves it
    (PEFT + SAM2ImageWrapper): the keys of `inventory`
    (`sam2_convert.reference_checkpoint_inventory`), each base or wrapper
    key holding its weight of `plain` and each `lora_A/lora_B.default` a
    seeded array, plus REF_VIDEO_KEYS. Returns the checkpoint and the
    plain dict with each target's W + (alpha/r)·B·A folded here in numpy
    float32, apart from the converter's fold."""
    from circuitvision_tpu_torch.models.sam2.convert import REFERENCE_LORA_TARGETS

    rng = np.random.default_rng(REF_SEEDS["lora"])
    prefix = "sam2_model.base_model.model."
    ckpt = {}
    for key, shape in inventory.items():
        if ".lora_" in key:
            ckpt[key] = (rng.standard_normal(shape) * REF_LORA_STD).astype(np.float32)
        else:
            ckpt[key] = plain[key.removeprefix(prefix).replace(".base_layer.", ".")]
    folded = dict(plain)
    for mod in REFERENCE_LORA_TARGETS:
        a = ckpt[f"{prefix}{mod}.lora_A.default.weight"]
        b = ckpt[f"{prefix}{mod}.lora_B.default.weight"]
        w, r = plain[f"{mod}.weight"], a.shape[0]
        scale = REF_LORA_ALPHA / r
        delta = scale * (b @ a) if w.ndim == 2 else \
            scale * np.einsum("or,rikl->oikl", b.reshape(w.shape[0], r), a)
        folded[f"{mod}.weight"] = w + delta.astype(w.dtype)
    for key, shape in REF_VIDEO_KEYS.items():
        ckpt[key] = np.zeros(shape, np.float32)
    return ckpt, folded


def _same_tree(np, what, got, want):
    """Leaf for leaf, dtype, shape and bytes, or AssertionError."""
    from circuitvision_tpu_torch.models.bridge import flatten

    got, want = dict(flatten(got)), dict(flatten(want))
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: leaves differ: {sorted(set(got) ^ set(want))[:8]}")
    bad = [k for k, w in want.items()
           if (got[k].dtype, got[k].shape) != (w.dtype, w.shape) or not np.array_equal(got[k], w)]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} leaves differ, e.g. {bad[:4]}")
    return len(want)


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def run_reference_deployment(torch, smi):
    """Phase 6b: the reference deployment from the reference's
    checkpoints (see the module docstring). Returns the launches of each
    kernel in one analyze()."""
    import os
    import statistics
    import tempfile

    import numpy as np

    from circuitvision_tpu_torch.core.config import PipelineConfig
    from circuitvision_tpu_torch.core.types import BBox
    from circuitvision_tpu_torch.io.image_io import encode_png
    from circuitvision_tpu_torch.models import bridge
    from circuitvision_tpu_torch.models.checkpoint import load_model_checkpoint
    from circuitvision_tpu_torch.models.sam2 import convert as sam2_convert
    from circuitvision_tpu_torch.models.sam2.wrapper import SAM2ImageSegmenter
    from circuitvision_tpu_torch.models.yolo import convert as yolo_convert
    from circuitvision_tpu_torch.models.yolo.decode import STRIDES
    from circuitvision_tpu_torch.models.yolo.model import YOLOv11
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch

    cfg = PipelineConfig()
    describe(cfg)
    det = cfg.detector
    ymeta = {"detector": {"scale": det.scale, "img_size": det.img_size,
                          "num_classes": det.num_classes, "reg_max": det.reg_max}}
    with torch.device("meta"):
        ymodel = YOLOv11(det.num_classes, det.scale, det.reg_max)
        smodel = SAM2ImageSegmenter(cfg.sam2)
    t0 = time.perf_counter()
    yvars = bridge.variables_from_state_dict(bridge.seeded_state("yolo", ymeta, REF_SEEDS["yolo"]),
                                             ymodel)
    svars = bridge.variables_from_state_dict(bridge.seeded_state("sam2", {}, REF_SEEDS["sam2"]),
                                             smodel)
    # state dicts in the reference's naming: ultralytics-nested YOLO with the
    # DFL arange and one num_batches_tracked a BatchNorm; PEFT-wrapped SAM2.1-L
    yref = {f"model.{k}": v for k, v in yolo_convert.export_torch_state(yvars).items()}
    for k in [k for k in yref if k.endswith(".bn.weight")]:
        yref[k[:-len("weight")] + "num_batches_tracked"] = np.zeros((), np.int64)
    yref["model.model.23.dfl.conv.weight"] = np.arange(
        det.reg_max, dtype=np.float32).reshape(1, det.reg_max, 1, 1)
    sref, folded = peft_reference(np, sam2_convert.export_torch_state(svars),
                                  sam2_convert.reference_checkpoint_inventory(
                                      bridge.variables_template(smodel)))
    expected = {"yolo": yvars, "sam2": sam2_convert.convert_state_dict(
        folded, bridge.variables_template(smodel))}
    seeded = dict(bridge.flatten(svars))
    moved = sum(not np.array_equal(w, seeded[k]) for k, w in bridge.flatten(expected["sam2"]))
    del folded
    # every key of the frozen inventories (the YOLO one without the
    # ultralytics nesting, as load_ultralytics_checkpoint returns it)
    inventory = {}
    for kind, ref, extra in (("yolo", {k.removeprefix("model."): v for k, v in yref.items()}, {}),
                             ("sam2", sref, REF_VIDEO_KEYS)):
        with open(REPO / "tests" / "fixtures" / f"{kind}_l_reference_checkpoint_keys.json") as f:
            frozen = {k: tuple(v) for k, v in json.load(f).items()}
        have = {k: tuple(np.shape(v)) for k, v in ref.items() if k not in extra}
        if have != frozen:
            raise AssertionError(f"{kind}: the built checkpoint is not the frozen inventory: "
                                 f"{sorted(set(have.items()) ^ set(frozen.items()))[:6]}")
        inventory[kind] = len(frozen)
    if moved != len(sam2_convert.REFERENCE_LORA_TARGETS):
        raise AssertionError(f"{moved} SAM2 leaves moved by the fold, expected "
                             f"{len(sam2_convert.REFERENCE_LORA_TARGETS)}")
    build_s = time.perf_counter() - t0

    image, bodies = draw_schematic(0)
    row = {"inventory_keys": inventory, "lora_targets_folded": moved, "build_s": build_s}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        files = {"yolo": tmp / "best.pt", "sam2": tmp / "best_miou_model_SAM_latest.pth"}
        for kind, ref in (("yolo", yref), ("sam2", sref)):
            torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ref.items()},
                       files[kind])
        del yref, sref
        # (1) the port's converter command line, (2) its reader, (3) leaf
        # for leaf against the expected folded weights
        readback = {}
        for kind in ("yolo", "sam2"):
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, "-m", "circuitvision_tpu_torch.models.checkpoint",
                                  f"convert-{kind}", str(files[kind]), str(tmp / kind)],
                                 cwd=REPO, capture_output=True, text=True, timeout=600)
            process_s = time.perf_counter() - t0
            said = re.search(r"converted .*: ([\d.]+) s to read and convert, ([\d.]+) s to write",
                             run.stdout)
            if run.returncode or not said:
                raise AssertionError(f"convert-{kind} failed ({run.returncode}):\n"
                                     f"{run.stdout}\n{run.stderr}")
            t0 = time.perf_counter()
            readback[kind], meta = load_model_checkpoint(str(tmp / kind))
            read_s = time.perf_counter() - t0
            leaves = _same_tree(np, f"{kind} read back", readback[kind], expected[kind])
            row[kind] = {"source_bytes": files[kind].stat().st_size, "process_s": process_s,
                         "convert_s": float(said[1]), "write_s": float(said[2]),
                         "bytes_written": _dir_bytes(tmp / kind),
                         "read_s": read_s, "leaves": leaves, "meta": meta}
        print(json.dumps({"reference_checkpoints": {**row, "card": smi}}), flush=True)

        # (4) the default PipelineConfig() from the read-back weights
        states = {k: bridge.state_dict_from_variables(v) for k, v in readback.items()}
        del readback
        conv = CircuitAnalyzerTorch(cfg, states["yolo"], states["sam2"], device="cuda")
        launches = timed_runs(torch, conv, image, "reference")
        ms = ANALYZE_MS["reference"]
        stages = {k: statistics.median(run[k] for run in ANALYZE_STAGES["reference"])
                  for k in ANALYZE_STAGES["reference"][0]}
        got = conv.analyze(image)
        mem = CircuitAnalyzerTorch(cfg, bridge.state_dict_from_variables(expected["yolo"]),
                                   bridge.state_dict_from_variables(expected["sam2"]),
                                   device="cuda")
        want = mem.analyze(image)
        diffs = {}
        for (s, g), r in zip(zip(STRIDES, conv.yolo_heads(image)[0]), mem.yolo_heads(image)[0]):
            diffs[f"yolo_head_stride{s}"] = (g, r)
        diffs["sam2_logits"] = (conv.segment_logits(image), mem.segment_logits(image))
        equal = {}
        for name, (g, r) in diffs.items():
            g, r = g.float(), r.float()
            err, tol = float((g - r).abs().max()), F32_PATH_RTOL * max(1.0, float(r.abs().max()))
            equal[name] = {"max_abs_err": err, "tol": tol}
            if not torch.isfinite(g).all() or err > tol:
                raise AssertionError(f"{name}: converted vs in-memory weights {err:.3e} > "
                                     f"{tol:.3e}")
        # the drawing's component bodies as the detections (--oracle-boxes),
        # with SAM2's mask and with the classical one: seeded SAM2.1-L
        # marks 99.7 % of the page foreground, so its mask leaves one node
        # and an empty netlist (PERF.md §6)
        oracle = {}
        for name, a in (("converted", conv), ("in_memory", mem)):
            a.bboxes = lambda img: [BBox("resistor", 1.0, *b, class_id=10) for b in bodies]
            oracle[f"{name}_sam2"] = a.analyze(image)
            a.sam2, sam2 = None, a.sam2
            oracle[f"{name}_classical"] = a.analyze(image)
            a.sam2 = sam2
            del a.bboxes
        del mem

        # (5) the CLI on the converted directories, in a process
        png = tmp / "schematic.png"
        png.write_bytes(encode_png(image))
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "circuitvision_tpu_torch.cli", "analyze",
                              str(png), "--yolo-checkpoint", str(tmp / "yolo"),
                              "--sam2-checkpoint", str(tmp / "sam2"),
                              "--netlist", str(tmp / "cli.cir")],
                             cwd=REPO, capture_output=True, text=True, timeout=600,
                             env={**os.environ, "CIRCUITVISION_VLM": ""})
        cli_s = time.perf_counter() - t0
        if run.returncode:
            raise AssertionError(f"cli analyze failed ({run.returncode}):\n{run.stderr[-3000:]}")
        cli_text = (tmp / "cli.cir").read_text()
    # the detections and node count the CLI printed, as cli.py prints them
    printed = run.stdout.split("=== detections ===\n", 1)[-1].split("=== netlist ===", 1)[0]
    want_printed = "".join(f"  {b.class_name:28s} conf={b.confidence:.2f} "
                           f"[{b.xmin},{b.ymin},{b.xmax},{b.ymax}]\n"
                           for b in got.bboxes_orig_nms) + f"=== nodes: {len(got.nodes)} ===\n"
    # (6) the temporary directory is gone; YOLO-l float32 card against CPU
    cfg32 = dataclasses.replace(cfg, detector=dataclasses.replace(det, dtype="float32"),
                                use_sam2=False)
    card32 = CircuitAnalyzerTorch(cfg32, states["yolo"], None, device="cuda")
    cpu32 = CircuitAnalyzerTorch(cfg32, states["yolo"], None, device="cpu")
    t0 = time.perf_counter()
    c_heads = cpu32.yolo_heads(image)[0]
    cpu_s = time.perf_counter() - t0
    f32 = {f"yolo_l_head_stride{s}": path_err(torch, f"YOLO-l head, stride {s}", g, c)
           for s, g, c in zip(STRIDES, card32.yolo_heads(image)[0], c_heads)}
    print(json.dumps({"reference_deployment": {
        "config": "PipelineConfig(): YOLOv11-l@640 (62 classes) + SAM2.1-L@1024, bfloat16",
        "analyze_ms_median": statistics.median(ms), "analyze_ms_min": min(ms),
        "analyze_ms_max": max(ms), "analyze_ms": ms, "stages_ms_median": stages,
        "launches_per_analyze": launches, "boxes": len(got.bboxes_orig_nms),
        "nodes": len(got.nodes), "netlist_lines": len(got.netlist_text.splitlines()),
        "converted_vs_in_memory": equal, "cli_s": cli_s,
        "oracle_boxes": {k: {"nodes": len(r.nodes), "netlist": r.netlist_text,
                             "mask_foreground": float((r.sam_mask > 0).mean())}
                         for k, r in oracle.items()},
        "cli_netlist_equal": cli_text == got.netlist_text + "\n",
        "cli_detections_equal": printed == want_printed,
        "f32_card_vs_cpu": f32, "cpu_f32_yolo_l_s": cpu_s, "card": smi}}), flush=True)
    if _box_keys(got) != _box_keys(want) or len(got.nodes) != len(want.nodes) \
            or got.netlist_text != want.netlist_text:
        raise AssertionError(f"converted and in-memory weights differ: boxes {_box_keys(got)} "
                             f"vs {_box_keys(want)}, nodes {len(got.nodes)} vs "
                             f"{len(want.nodes)}, netlists\n{got.netlist_text}\n--\n"
                             f"{want.netlist_text}")
    if cli_text != got.netlist_text + "\n" or printed != want_printed:
        raise AssertionError(f"the CLI's result differs:\n{printed}{cli_text}\n--\n"
                             f"{want_printed}{got.netlist_text}")
    texts = {k: r.netlist_text for k, r in oracle.items()}
    if texts["converted_sam2"] != texts["in_memory_sam2"] or not texts["converted_classical"] \
            or texts["converted_classical"] != texts["in_memory_classical"]:
        raise AssertionError(f"oracle-box netlists differ across converted and in-memory "
                             f"weights, or the classical one is empty: {texts}")
    return launches


def run_off_preset(torch, smi, name, config, seed):
    """Phase 9: the Hiera trunk of `config` (an off-preset head width) in
    bf16 on the card with exact launch counts (EXPECTED[name]) against the
    same seeded weights in float32 on the CPU. Returns the launches."""
    import numpy as np

    from circuitvision_tpu_torch.models.bridge import sam2_config, seeded_state
    from circuitvision_tpu_torch.models.layers import place
    from circuitvision_tpu_torch.models.sam2.wrapper import SAM2ImageSegmenter

    meta = {"sam2": {"preset": "l", "overrides": config}}
    state = seeded_state("sam2", meta, seed)

    def trunk(device, dtype):
        m = SAM2ImageSegmenter(sam2_config(meta))
        m.load_state_dict(state)
        return place(m, device, dtype).eval().trunk

    res = config["resolution"]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, res, res, 3))
                         .astype(np.float32))
    card = trunk("cuda", torch.bfloat16)
    reset, read = counters()
    with torch.no_grad():
        card(x.cuda())  # warm-up
        reset()
        torch.cuda.synchronize()
        got = card(x.cuda())
        torch.cuda.synchronize()
        counts = read()
        t0 = time.perf_counter()
        ref = trunk("cpu", torch.float32)(x)
    print(f"   cpu float32 {name} trunk: {time.perf_counter() - t0:.3f} s", flush=True)
    stages = []
    for g, r in zip(got, ref):
        d = g.float().cpu() - r
        rms = float(d.pow(2).mean().sqrt()) / float(r.pow(2).mean().sqrt())
        stages.append({"shape": list(r.shape), "max_abs_err": float(d.abs().max()),
                       "max_abs_ref": float(r.abs().max()), "rel_rms": rms,
                       "finite": bool(torch.isfinite(g).all())})
    print(json.dumps({"off_preset_bf16_card_vs_f32_cpu": {
        "name": name, "head_width": config["embed_dim"] // config["num_heads"],
        "config": config, "launches": counts, "stages": stages, "tol_max": OFF_PRESET_MAX,
        "tol_rms": OFF_PRESET_RMS, "card": smi}}), flush=True)
    if counts != EXPECTED[name]:
        raise AssertionError(f"{name}: launches {counts} != {EXPECTED[name]}")
    for st in stages:
        if not st["finite"] or st["max_abs_err"] > OFF_PRESET_MAX * st["max_abs_ref"] \
                or st["rel_rms"] > OFF_PRESET_RMS:
            raise AssertionError(f"{name} bf16 trunk differs from f32: {st}")
    return counts


def _box_keys(result):
    return [(b.class_name, b.xmin, b.ymin, b.xmax, b.ymax) for b in result.bboxes_orig_nms]


def _directions(result):
    return [(b.semantic_direction, b.semantic_reason) for b in result.bboxes]


def product_config(ymeta, smeta, **topology):
    """The trained product's PipelineConfig (scripts/bench_trained_product.py):
    the detector of ckpt/yolo's meta in its shipped bf16, SAM2 of
    ckpt/sam2's meta in its trained float32."""
    from circuitvision_tpu_torch.core.config import PipelineConfig, TopologyConfig
    from circuitvision_tpu_torch.models.bridge import detector_config, sam2_config

    return PipelineConfig(detector=detector_config(ymeta), sam2=sam2_config(smeta),
                          topology=TopologyConfig(**topology))


def run_trained_product(torch, smi):
    """The trained product at YOLOv11-s@640 + Hiera-t@512 + the crop
    reader: the three shipped checkpoints and the eval PNGs read by the
    port's own readers; (a) card against CPU in float32 on PRODUCT_PARITY;
    (b) the shipped dtypes: analyze() + generate_final_netlist over the
    first PRODUCT_IMAGES eval images, timed, with exact launch counts, the
    SAM2 foreground share and mask IoU against eval_data/masks; (c)
    analyze_many(finalize=True) in chunks of PRODUCT_BATCH with the line
    enhancement kernel on, timed, each netlist the card's serial one; (d)
    netlist_exact_match against eval_data/netlists. Returns the launches
    of one analyze() and of one analyze_many(), and what the serving phase
    reuses: the eval PNG paths and images, the batched analyzer (fused
    morphology on), the serial analyzer, and both runs' results."""
    import ctypes.util
    import statistics

    import numpy as np

    from circuitvision_tpu_torch.enrich.trained_reader import TrainedReaderClient
    from circuitvision_tpu_torch.eval.metrics import mask_iou, netlist_exact_match
    from circuitvision_tpu_torch.io.image_io import load_image, read_png
    from circuitvision_tpu_torch.models.bridge import state_dict_from_variables
    from circuitvision_tpu_torch.models.checkpoint import load_model_checkpoint
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch

    lib = ctypes.util.find_library("zstd")
    print(f"   find_library('zstd'): {lib}", flush=True)
    loaded, load_s = {}, {}
    for name in ("yolo", "sam2", "reader"):
        t0 = time.perf_counter()
        loaded[name] = load_model_checkpoint(str(REPO / "ckpt" / name))
        load_s[name] = time.perf_counter() - t0
    (yv, ymeta), (sv, smeta), (rv, _) = loaded["yolo"], loaded["sam2"], loaded["reader"]
    ystate, sstate, rstate = (state_dict_from_variables(v) for v in (yv, sv, rv))

    data = REPO / "eval_data"
    paths = sorted((data / "images").glob("*.png"))[:PRODUCT_IMAGES]
    load_image(str(paths[0]))  # builds the row unfilter (g++) outside the timing
    t0 = time.perf_counter()
    images = [load_image(str(p)) for p in paths]
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
    masks = [read_png(str(data / "masks" / p.name)) for p in paths]
    print(json.dumps({"trained_product_inputs": {
        "zstd_library": lib, "checkpoint_load_s": load_s, "images": [p.stem for p in paths],
        "png_decode_ms_per_image": decode_ms, "card": smi}}), flush=True)

    def analyzer(cfg, device):
        return CircuitAnalyzerTorch(cfg, ystate, sstate, device=device,
                                    vlm_client=TrainedReaderClient(rstate, device=device))

    # (a) float32, TF32 off: the card against the CPU
    cfg = product_config(ymeta, smeta)
    cfg32 = dataclasses.replace(cfg, detector=dataclasses.replace(cfg.detector, dtype="float32"))
    card32, cpu32 = analyzer(cfg32, "cuda"), analyzer(cfg32, "cpu")
    parity = []
    for stem in PRODUCT_PARITY:
        img = load_image(str(data / "images" / f"{stem}.png"))
        g = card32.generate_final_netlist(card32.analyze(img))
        c = cpu32.generate_final_netlist(cpu32.analyze(img))
        row = {"image": stem,
               "sam2_logits": path_err(torch, f"{stem} SAM2 logits",
                                       card32.segment_logits(g.image_for_analysis),
                                       cpu32.segment_logits(c.image_for_analysis)),
               "boxes_equal": _box_keys(g) == _box_keys(c), "n_boxes": len(g.bboxes_orig_nms),
               "mask_agreement": float(np.mean(g.sam_mask == c.sam_mask))
               if g.sam_mask.shape == c.sam_mask.shape else 0.0,
               "reader_rows_equal": g.vlm_stage2_output == c.vlm_stage2_output,
               "directions_equal": _directions(g) == _directions(c),
               "final_netlist_equal": g.netlist_text == c.netlist_text,
               "netlist": g.netlist_text}
        parity.append(row)
        print(json.dumps({"trained_product_f32_card_vs_cpu": row}), flush=True)
        if not (row["boxes_equal"] and row["reader_rows_equal"] and row["directions_equal"]
                and row["final_netlist_equal"]) or row["mask_agreement"] < MASK_AGREEMENT_MIN:
            raise AssertionError(f"trained product, {stem}: card and CPU differ: {row}")
    del card32, cpu32

    # (b) the shipped dtypes, serial
    card = analyzer(cfg, "cuda")
    reset, read = counters()
    card.generate_final_netlist(card.analyze(images[0]))  # warm-up
    runs, serial = [], None
    for _ in range(PRODUCT_RUNS):
        stage_s: dict = {}
        results = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for img in images:
            reset()
            r = card.generate_final_netlist(card.analyze(img))
            counts = read()
            if counts != EXPECTED["t@512"]:
                raise AssertionError(f"trained product: launches per analyze {counts} != "
                                     f"{EXPECTED['t@512']}")
            results.append(r)
            for k, v in r.timings.timings.items():
                stage_s[k] = stage_s.get(k, 0.0) + v
        torch.cuda.synchronize()
        runs.append({"ms_per_image": (time.perf_counter() - t0) * 1e3 / len(images),
                     "stages_ms_per_image": {k: v * 1e3 / len(images)
                                             for k, v in stage_s.items()}})
        serial = results
    launches = counts
    ms = [r["ms_per_image"] for r in runs]
    sam2_ms = [r["stages_ms_per_image"][SAM2_STAGE] for r in runs]
    fg, ious = [], []
    for r, gt in zip(serial, masks):
        if not gt.any():
            continue  # no wire in the ground truth (the degen_* images): IoU undefined
        share = float(np.mean(r.sam_mask > 0))
        fg.append(share)
        pred = r.sam_mask
        if pred.shape != gt.shape:  # the mask is the crop's: back into the image's frame
            full = np.zeros(gt.shape, np.uint8)
            info = r.crop_info
            if info is not None and info.applied and info.window:
                x0, y0, x1, y1 = info.window
                full[y0:y1, x0:x1] = pred
            pred = full
        ious.append(mask_iou(pred, gt))
    if not fg or not all(0.0 < f < 1.0 for f in fg):
        raise AssertionError(f"trained SAM2 foreground shares {fg}: a mask is empty or full")

    # (c) analyze_many(finalize=True), the line enhancement kernel on
    batch = analyzer(product_config(ymeta, smeta, use_fused_morphology=True), "cuda")
    batch.analyze_batch(images[:PRODUCT_BATCH], batch_size=PRODUCT_BATCH, finalize=True)
    ips, batched = [], None
    for _ in range(PRODUCT_RUNS):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batched = batch.analyze_batch(images, batch_size=PRODUCT_BATCH, finalize=True)
        torch.cuda.synchronize()
        ips.append(len(images) / (time.perf_counter() - t0))
        batch_counts = read()
    with_mask = sum(r.sam_mask is not None for r in batched)
    want = {**{k: v * -(-len(images) // PRODUCT_BATCH) for k, v in EXPECTED["t@512"].items()},
            "enhance_lines_fused": with_mask}
    if batch_counts != want or want != EXPECTED["batch"]:
        raise AssertionError(f"trained product batched: launches {batch_counts} != {want}")
    differ = [p.stem for p, b, s_ in zip(paths, batched, serial)
              if b.netlist_text != s_.netlist_text]

    # (d) fidelity against the eval set's reference netlists, reported
    refs = [(data / "netlists" / f"{p.stem}.cir") for p in paths]
    have = [i for i, f in enumerate(refs) if f.exists()]
    exact = netlist_exact_match([serial[i].netlist_text for i in have],
                                [refs[i].read_text() for i in have])
    valued = sum(1 for r in serial for line in r.netlist_text.splitlines()
                 if line and not line.endswith("None"))
    print(json.dumps({"trained_product": {
        "config": "YOLOv11-s@640 bf16 + SAM2 Hiera-t@512 f32 + crop reader f32 (ckpt/)",
        "images": len(images),
        "analyze_final_ms_per_image": {"median": statistics.median(ms), "min": min(ms),
                                       "max": max(ms), "runs": runs},
        "sam2_stage_ms_per_image": {"median": statistics.median(sam2_ms), "min": min(sam2_ms),
                                    "max": max(sam2_ms)},
        "analyze_many_finalize_images_per_s": {"median": statistics.median(ips),
                                               "min": min(ips), "max": max(ips), "runs": ips,
                                               "batch_size": PRODUCT_BATCH},
        "launches_per_analyze": launches, "launches_per_analyze_many": batch_counts,
        "sam2_foreground_share_mean": float(np.mean(fg)), "images_with_gt_wires": len(fg),
        "mask_iou_mean": float(np.mean(ious)),
        "netlist_exact_match": exact, "netlists_compared": len(have),
        "valued_netlist_lines": valued, "batched_netlists_differing_from_serial": differ,
        "card": smi}}), flush=True)
    print(f"   trained product on {smi}: analyze()+final {statistics.median(ms):.1f} ms/image "
          f"(median of {PRODUCT_RUNS}; SAM2 stage {statistics.median(sam2_ms):.2f}), "
          f"analyze_many(finalize) {statistics.median(ips):.2f} "
          f"images/s, netlist exact match {exact:.3f} over {len(have)}", flush=True)
    if differ:
        raise AssertionError(f"trained product: batched netlists differ from serial on {differ}")
    product = {"paths": paths, "images": images, "batch": batch, "serial_analyzer": card,
               "serial": serial, "batched": batched, "with_mask": with_mask}
    return launches, batch_counts, product


def _http():
    """An opener for the local server that no proxy setting reroutes."""
    import urllib.request

    return urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _post(http, url, body):
    """(status, JSON payload, seconds) of one POST /analyze."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"{url}/analyze", data=body, method="POST")
    t0 = time.perf_counter()
    try:
        with http.open(req, timeout=300) as resp:
            code, payload = resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        code, payload = e.code, json.loads(e.read())
    return code, payload, time.perf_counter() - t0


def _get(http, url):
    with http.open(url, timeout=30) as resp:
        return resp.read()


def _metrics(text):
    """Prometheus text → {name with labels: value}; raises on a line that
    does not parse."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        out[name] = float(value)
    return out


def _listen_overflows():
    """The kernel's count of connections dropped from a full listen queue
    (TcpExt ListenOverflows in /proc/net/netstat), or None without it."""
    try:
        lines = Path("/proc/net/netstat").read_text().splitlines()
    except OSError:
        return None
    for names, values in zip(lines[::2], lines[1::2]):
        if names.startswith("TcpExt:"):
            table = dict(zip(names.split()[1:], values.split()[1:]))
            return int(table["ListenOverflows"]) if "ListenOverflows" in table else None
    return None


def _pct(values, p):
    v = sorted(values)
    return v[min(len(v) - 1, int(p * len(v)))]


def run_serving(torch, smi, product):
    """Phase 8c, on the trained product phase's analyzers and images.
    (a) serving: `serve`'s pieces — BatchedPipeline (chunks of
    PRODUCT_BATCH, fused morphology on) + BatchingExecutor(final=True) +
    make_server(port=0) — with SERVE_CLIENTS client threads POSTing the
    eval PNGs' bytes, one request per image, a warm-up round and
    SERVE_ROUNDS timed rounds, each beside a timed
    analyze_many(finalize=True) on the same images: every
    served netlist byte-equal to analyze_many's, /stats and /metrics, a
    body that is not a PNG answered 500 and the next request served, exact
    launch counts per round (the t@512 counts × /stats' batches, one line
    enhancement per image with a mask). (b) simulation: analyzer.simulate
    on each served result (DC, or structured AC at 60 Hz), and the 63
    eval netlists through perform_dc_analysis / perform_ac_analysis_text
    with the native solver (g++ here, timed) and with numpy, which must
    agree. (c) the CLI, as subprocesses: `simulate` on an eval netlist
    that solves, and `analyze` with the shipped checkpoints, the reader
    and --simulate dc, whose netlist is the serial analyze()'s. Returns
    the launches of the last served round."""
    import os
    import statistics
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from circuitvision_tpu_torch.core.config import SimConfig
    from circuitvision_tpu_torch.netlist.values import detect_analysis_mode
    from circuitvision_tpu_torch.pipeline.batch import BatchedPipeline
    from circuitvision_tpu_torch.pipeline.server import BatchingExecutor, make_server
    from circuitvision_tpu_torch.sim import native_backend
    from circuitvision_tpu_torch.sim.engine import perform_ac_analysis_text, perform_dc_analysis

    paths, images, analyzer = product["paths"], product["images"], product["batch"]
    want = [r.netlist_text for r in product["batched"]]
    bodies = [p.read_bytes() for p in paths]
    n = len(paths)
    reset, read = counters()
    http = _http()

    # (a) serving
    rounds, latencies = [], []
    with BatchingExecutor(BatchedPipeline(analyzer, batch_size=PRODUCT_BATCH), final=True) as ex:
        server = make_server(ex, port=0)
        serving = threading.Thread(target=server.serve_forever, daemon=True)
        serving.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            def served_round():
                """POST every image, check each reply and the round's
                launches; (seconds, batches, request latencies)."""
                before = ex.stats()
                reset()
                t0 = time.perf_counter()
                with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
                    outs = list(pool.map(lambda b: _post(http, url, b), bodies))
                wall = time.perf_counter() - t0
                counts, after = read(), ex.stats()
                bad = [(p.stem, code, payload.get("error")) for p, (code, payload, _) in
                       zip(paths, outs) if code != 200]
                if bad:
                    raise AssertionError(f"served requests failed: {bad}")
                differ = [p.stem for p, (_, payload, _), w in zip(paths, outs, want)
                          if payload["netlist_text"] != w]
                if differ:
                    raise AssertionError(f"served netlists differ from analyze_many's on {differ}")
                batches = after["batches"] - before["batches"]
                expected = {**{k: v * batches for k, v in EXPECTED["t@512"].items()},
                            "enhance_lines_fused": product["with_mask"]}
                if counts != expected:
                    raise AssertionError(f"served launches {counts} != {expected} "
                                         f"({batches} batches)")
                return wall, batches, [dt for _, _, dt in outs], counts

            served_round()  # warm-up: batch sizes the product phase never ran
            overflows = _listen_overflows()
            for _ in range(SERVE_ROUNDS):
                wall, batches, lat, counts = served_round()
                latencies += lat
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                analyzer.analyze_batch(images, batch_size=PRODUCT_BATCH, finalize=True)
                torch.cuda.synchronize()
                rounds.append({"served_images_per_s": n / wall, "batches": batches,
                               "mean_batch_size": n / batches,
                               "analyze_many_finalize_images_per_s":
                                   n / (time.perf_counter() - t1)})
            if overflows is not None:
                overflows = _listen_overflows() - overflows
                if overflows:
                    raise AssertionError(f"{overflows} connections overflowed the listen queue")
            stats = ex.stats()
            if stats["completed"] != (SERVE_ROUNDS + 1) * n or stats["failed"] != 0:
                raise AssertionError(f"/stats after {SERVE_ROUNDS + 1} rounds of {n}: {stats}")
            served_stats = json.loads(_get(http, f"{url}/stats"))
            metrics = _metrics(_get(http, f"{url}/metrics").decode())
            if metrics["circuitvision_completed_total"] != served_stats["completed"] or \
                    served_stats != {**stats, "queue_depth": served_stats["queue_depth"]}:
                raise AssertionError(f"/metrics {metrics} or /stats {served_stats} disagree "
                                     f"with {stats}")
            code, payload, _ = _post(http, url, b"\xff\xd8\xff\xe0 not a PNG")
            if code != 500 or not payload.get("error"):
                raise AssertionError(f"a body that is not a PNG got {code} {payload}")
            code, payload, _ = _post(http, url, bodies[0])
            if code != 200 or payload["netlist_text"] != want[0]:
                raise AssertionError(f"the request after a bad body: {code} {payload}")
            if json.loads(_get(http, f"{url}/healthz")) != {"ok": True}:
                raise AssertionError("/healthz is not ok after serving")
            # the results themselves, through the executor, for (b)
            results = ex.map(images)
        finally:
            server.shutdown()
            server.server_close()
            serving.join(timeout=30)
    if [r.netlist_text for r in results] != want:
        raise AssertionError("executor.map netlists differ from analyze_many's")
    final_stats = ex.stats()
    mean_batch = n * SERVE_ROUNDS / sum(r["batches"] for r in rounds)
    served = {
        "config": "YOLOv11-s@640 bf16 + SAM2 Hiera-t@512 f32 + crop reader (ckpt/), "
                  f"batch {PRODUCT_BATCH}, fused morphology, final=True",
        "images": n, "clients": SERVE_CLIENTS, "rounds": rounds,
        "served_images_per_s_median": statistics.median(
            r["served_images_per_s"] for r in rounds),
        "analyze_many_finalize_images_per_s_median": statistics.median(
            r["analyze_many_finalize_images_per_s"] for r in rounds),
        "client_latency_s": {"p50": _pct(latencies, 0.50), "p99": _pct(latencies, 0.99),
                             "max": max(latencies), "requests": len(latencies)},
        "server_latency_s_all_rounds": stats["latency_s"], "mean_batch_size": mean_batch,
        "stats_after": final_stats, "launches_per_round": counts,
        "listen_overflows": overflows, "bad_body_status": 500, "card": smi}
    print(json.dumps({"serving": served}), flush=True)
    print(f"   served on {smi}: {served['served_images_per_s_median']:.2f} images/s "
          f"(median of {SERVE_ROUNDS} rounds of {n}, {SERVE_CLIENTS} clients), p50 "
          f"{served['client_latency_s']['p50'] * 1e3:.1f} ms, p99 "
          f"{served['client_latency_s']['p99'] * 1e3:.1f} ms, mean batch "
          f"{mean_batch:.2f}; analyze_many(finalize) "
          f"{served['analyze_many_finalize_images_per_s_median']:.2f} images/s", flush=True)

    # (b) simulation
    t0 = time.perf_counter()
    native_backend.load_library()
    build_s = time.perf_counter() - t0
    sims = {}
    for p, r in zip(paths, results):
        sim = analyzer.simulate(r)
        sims[p.stem] = {"mode": detect_analysis_mode(r.netlist_text), "ok": sim.ok,
                        "error": sim.error}
    eval_sims, singular = {}, []
    for f in sorted((REPO / "eval_data" / "netlists").glob("*.cir")):
        text = f.read_text()
        ac = detect_analysis_mode(text) == "AC"
        native, numpy_ = (
            perform_ac_analysis_text(text, 60.0, SimConfig(prefer_native=nat)) if ac
            else perform_dc_analysis(text, SimConfig(prefer_native=nat)) for nat in (True, False))
        if (native.ok, native.node_voltages, native.branch_currents) != \
                (numpy_.ok, numpy_.node_voltages, numpy_.branch_currents):
            raise AssertionError(f"{f.name}: native {native} != numpy {numpy_}")
        if native.error != numpy_.error:
            # the two solvers word a singular matrix differently (so do the
            # JAX package's); any other difference is a fault
            if not ("solve failed (code 1; singular matrix?)" in (native.error or "")
                    and "singular MNA matrix" in (numpy_.error or "")):
                raise AssertionError(f"{f.name}: errors {native.error!r} != {numpy_.error!r}")
            singular.append(f.stem)
        eval_sims[f.stem] = {"mode": "AC" if ac else "DC", "ok": native.ok}

    def tally(d):
        out = {}
        for v in d.values():
            key = f"{v['mode']} {'ok' if v['ok'] else 'failed'}"
            out[key] = out.get(key, 0) + 1
        return out

    simulation = {"native_build_s": build_s, "served_results": tally(sims),
                  "served_errors": {k: v["error"] for k, v in sims.items() if not v["ok"]},
                  "eval_netlists": tally(eval_sims),
                  "singular_matrix_wording_differs": singular}
    print(json.dumps({"simulation": simulation}), flush=True)

    # (c) the CLI
    dc_file = next(REPO / "eval_data" / "netlists" / f"{k}.cir" for k, v in eval_sims.items()
                   if v["mode"] == "DC" and v["ok"])
    cli = [sys.executable, "-m", "circuitvision_tpu_torch.cli"]
    t0 = time.perf_counter()
    out = subprocess.run(cli + ["simulate", str(dc_file)], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0 or "node voltages" not in out.stdout:
        raise AssertionError(f"cli simulate {dc_file.name}: {out.returncode}\n{out.stdout}"
                             f"\n{out.stderr[-2000:]}")
    simulate_s = time.perf_counter() - t0
    ckpt = REPO / "ckpt"
    env = {**os.environ, "CIRCUITVISION_VLM": f"reader:{ckpt / 'reader'}"}
    t0 = time.perf_counter()
    out = subprocess.run(cli + ["analyze", str(paths[0]), "--scale", "s", "--yolo-checkpoint",
                                str(ckpt / "yolo"), "--sam2-checkpoint", str(ckpt / "sam2"),
                                "--final", "--simulate", "dc"],
                         cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    analyze_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"cli analyze: {out.returncode}\n{out.stdout}\n{out.stderr[-4000:]}")
    printed = out.stdout.split("=== netlist ===\n", 1)[1].split("\n=== timings ===", 1)[0]
    serial = product["serial"][0]
    if printed != (serial.netlist_text or "(empty)"):
        raise AssertionError(f"cli analyze netlist differs from analyze()'s:\n{printed}\n--\n"
                             f"{serial.netlist_text}")
    sim = product["serial_analyzer"].simulate(serial)
    if (f"simulation failed: {sim.error}" if not sim.ok else
            json.dumps(sim.node_voltages, indent=2, ensure_ascii=False)) not in out.stdout:
        raise AssertionError(f"cli analyze --simulate printed another result:\n{out.stdout}")
    print(json.dumps({"cli": {"simulate": dc_file.name, "simulate_s": simulate_s,
                              "analyze": paths[0].name, "analyze_s": analyze_s,
                              "netlist_equal": True, "simulation_ok": sim.ok, "card": smi}}),
          flush=True)
    return counts


def run_width60_kernels(torch, smi):
    """Phase 9 for width 60: rows of true width 60 zero-padded to 64, as
    a bf16 block off a multiple of 8 runs them (hiera.pad_block), at the
    off-preset-60 trunk's stage-1 shapes — mlp_block and ln_qkv with the
    LayerNorm dividing by 60, each against its plain version on the same
    card tensors and against the unpadded plain function, the padding
    left zero; then both blocks of width 60 (stage 1's window block, the
    60 → 120 transition) on the card against the same blocks on the CPU
    with the padded route taken there by the plain versions. Device times
    of the two kernels beside the float32 kernels that ran those blocks
    before (the float32 detour: the unpadded rows in float32)."""
    import copy

    from circuitvision_tpu_torch.models.layers import place
    from circuitvision_tpu_torch.models.sam2 import hiera
    from circuitvision_tpu_torch.ops.cuda import global_attn as ga
    from circuitvision_tpu_torch.ops.cuda import mlp_block as mb

    gen = torch.Generator(device="cuda").manual_seed(60)
    f32, bf = torch.float32, torch.bfloat16
    c, cp, t = 60, 64, WIDTH60_ROWS

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    def pad(x, width=cp):
        return torch.nn.functional.pad(x, (0, width - x.shape[-1]))

    def check(name, got, ref):
        got, ref = got.float(), ref.float()
        ref_max = float(ref.abs().max())
        err = float((got - ref).abs().max())
        tol = tolerance("bfloat16", ref_max)
        if not (bool(torch.isfinite(got).all()) and err <= tol):
            raise AssertionError(f"width 60 {name}: max |err| {err} > {tol}")
        return err, tol

    ln = (pad(1 + rnd(c, scale=0.1, dtype=f32)), pad(rnd(c, scale=0.1, dtype=f32)))
    x = pad(rnd(t, c))
    w0, b0 = pad(rnd(4 * c, c, scale=c ** -0.5)), rnd(4 * c, scale=0.02)
    w1 = pad(rnd(c, 4 * c, scale=(4 * c) ** -0.5).t()).t().contiguous()
    b1 = pad(rnd(c, scale=0.02))
    wq, bq = pad(rnd(3 * cp, c, scale=c ** -0.5)), rnd(3 * cp, scale=0.02)
    xw = x.view(t // 64, 64, cp)
    rows = {}
    with torch.no_grad():
        out = mb.mlp_block(x, *ln, w0, b0, w1, b1, ln_width=c)
        if out[:, c:].any():
            raise AssertionError("width 60 mlp_block: the padding is not zero")
        rows["mlp_block"] = {
            "vs_plain": check("mlp_block", out, mb.mlp_block_plain(x, *ln, w0, b0, w1, b1,
                                                                     ln_width=c)),
            "vs_unpadded_plain": check("mlp_block unpadded", out[:, :c], mb.mlp_block_plain(
                x[:, :c], ln[0][:c], ln[1][:c], w0[:, :c], b0, w1[:c], b1[:c])),
            "bf16_padded_ms": graph_ms(lambda: mb.mlp_block(x, *ln, w0, b0, w1, b1,
                                                              ln_width=c)),
            "f32_unpadded_ms": graph_ms(lambda a=(x[:, :c].float().contiguous(),
                                                  ln[0][:c].contiguous(), ln[1][:c].contiguous(),
                                                  w0[:, :c].float().contiguous(), b0.float(),
                                                  w1[:c].float().contiguous(),
                                                  b1[:c].float().contiguous()):
                                        mb.mlp_block(*a))}
        q = ga.ln_qkv(xw, *ln, wq, bq, 1, ln_width=c)
        rows["ln_qkv"] = {
            "vs_plain": check("ln_qkv", q, ga.ln_qkv_plain(xw, *ln, wq, bq, 1, ln_width=c)),
            "vs_unpadded_plain": check("ln_qkv unpadded", q, ga.ln_qkv_plain(
                xw[..., :c], ln[0][:c], ln[1][:c], wq[:, :c], bq, 1)),
            "bf16_padded_ms": graph_ms(lambda: ga.ln_qkv(xw, *ln, wq, bq, 1, ln_width=c)),
            "f32_unpadded_ms": graph_ms(lambda a=(xw[..., :c].float().contiguous(),
                                                  ln[0][:c].contiguous(), ln[1][:c].contiguous(),
                                                  wq[:, :c].float().contiguous(), bq.float()):
                                        ga.ln_qkv(*a, 1))}
    blocks = []
    torch.manual_seed(60)
    for dim, dim_out, q_stride in ((60, 60, False), (60, 120, True)):
        blk = hiera.MultiScaleBlock(dim, dim_out, dim_out // 60, q_stride=q_stride)
        with torch.no_grad():
            for p_ in blk.parameters():
                p_.normal_(0.0, 0.1)
        cpu = place(blk, "cpu", bf).eval()
        card = place(copy.deepcopy(cpu), "cuda", bf)
        xb = rnd(64, 8, 8, dim)
        reset, read = counters()
        with torch.no_grad():
            reset()
            got = card(xb, 8, not q_stride)
            counts = {k: v for k, v in read().items() if v}
            saved = hiera.pad_block
            hiera.pad_block = lambda t_, d, do: t_.dtype == bf and bool(d % 8 or do % 8)
            try:
                ref = cpu(xb.cpu(), 8, not q_stride)
            finally:
                hiera.pad_block = saved
        err, tol = check(f"block {dim}->{dim_out}", got.cpu(), ref)
        blocks.append({"dim": dim, "dim_out": dim_out, "launches": counts, "max_abs_err": err,
                       "tol": tol})
        if counts.get("mlp_block") != 1 or counts.get("ln_qkv") != (2 if q_stride else 1):
            raise AssertionError(f"width 60 block {dim}->{dim_out}: launches {counts}")
    print(json.dumps({"width60_bf16_kernels": {"rows": t, "kernels": rows, "blocks": blocks,
                                               "card": smi}}), flush=True)


def run_web_ui(torch, smi, product):
    """Phase 8d: image input and the web UI on the trained product (the
    serial analyzer of run_trained_product). Returns the launches of one
    POST /analyze."""
    import base64
    import hashlib
    import statistics
    import threading

    from circuitvision_tpu_torch import webapp
    from circuitvision_tpu_torch.core.viz import create_annotated_image
    from circuitvision_tpu_torch.io.image_io import ImageFormatError, decode_image

    fx = REPO / "eval_data" / "image_fixtures"
    digests = json.loads((fx / "digests.json").read_text())
    files = {name: (fx / name).read_bytes() for name in digests}
    decode_image(files["baseline_420.jpg"])  # builds the decoder outside the timing
    bad = []
    for name, entry in digests.items():
        try:
            arr = decode_image(files[name])
        except ImageFormatError as exc:
            bad.append(f"{name}: {exc}")
            continue
        got = [list(arr.shape), hashlib.sha256(arr.tobytes()).hexdigest()]
        if got != [entry["shape"], entry["sha256"]]:
            bad.append(f"{name}: {got}")

    def decode_ms(blobs, reps=5):
        per = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for b in blobs:
                decode_image(b)
            per.append((time.perf_counter() - t0) * 1e3 / len(blobs))
        return statistics.median(per)
    paths = product["paths"]
    jpegs = [files[f"eval/{p.stem}.jpg"] for p in paths]
    pngs = [p.read_bytes() for p in paths]
    inputs = {"eval_jpeg_ms_per_image": decode_ms(jpegs), "eval_png_ms_per_image": decode_ms(pngs),
              "photo_jpeg_ms": decode_ms([files["photo.jpg"]]),
              "photo_shape": digests["photo.jpg"]["shape"]}
    print(json.dumps({"image_input": {"fixtures": len(digests), "mismatches": bad, **inputs,
                                      "card": smi}}), flush=True)
    if bad:
        raise AssertionError(f"image fixtures the port decodes otherwise than PIL: {bad}")

    analyzer = product["serial_analyzer"]
    server = webapp.make_server(analyzer, port=0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    http = _http()
    uploads = [(f"{p.stem}.jpg", b) for p, b in zip(paths, jpegs)] + \
        [(p.name, b) for p, b in zip(paths, pngs)]
    reset, read = counters()
    try:
        _post(http, url, uploads[0][1])  # warm-up
        req_ms, analyze_ms, mismatches, counts = {"jpeg": [], "png": []}, [], [], None
        stage_inputs = []
        for _ in range(WEB_ROUNDS):
            for name, body in uploads:
                reset()
                code, payload, sec = _post(http, url, body)
                counts = read()
                if code != 200:
                    raise AssertionError(f"web UI {name}: {code} {payload}")
                if counts != EXPECTED["t@512"]:
                    raise AssertionError(f"web UI {name}: launches {counts} != "
                                         f"{EXPECTED['t@512']}")
                req_ms["jpeg" if name.endswith(".jpg") else "png"].append(sec * 1e3)
                served = webapp._STATE["result"]
                if name.endswith(".png") and served.sam_mask is not None:
                    stage_inputs.append((served.sam_mask, served.bboxes))
                pixels = decode_image(body)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = analyzer.analyze(pixels)
                torch.cuda.synchronize()
                analyze_ms.append((time.perf_counter() - t0) * 1e3)
                images = {"annotated": create_annotated_image(served.image_for_analysis,
                                                              served.bboxes),
                          "annotated_orig": create_annotated_image(pixels,
                                                                   served.bboxes_orig_nms),
                          "node_viz": served.node_visualization,
                          "contour_viz": served.contour_visualization,
                          "connection_viz": served.connection_points_visualization}
                for key, arr in images.items():
                    sent = payload[key]
                    same = (sent == "" if arr is None else
                            (decode_image(base64.b64decode(sent)) == arr).all())
                    if not same:
                        mismatches.append(f"{name} {key}")
                if payload["netlist_text"] != (want.netlist_text or ""):
                    mismatches.append(f"{name} netlist")
    finally:
        server.shutdown()
        server.server_close()
    # the node stage with and without its debug images on the served masks
    from circuitvision_tpu_torch.topology.nodes import extract_nodes
    node_ms = {}
    for fetch in (False, True, False, True):
        t0 = time.perf_counter()
        for mask, boxes in stage_inputs:
            extract_nodes(mask, boxes, analyzer.cfg.topology, device=analyzer.device,
                          fetch_viz=fetch)
        torch.cuda.synchronize()
        node_ms.setdefault(fetch, []).append((time.perf_counter() - t0) * 1e3 / len(stage_inputs))
    row = {"uploads": len(uploads), "rounds": WEB_ROUNDS,
           "node_stage_ms": {"without_debug_images": min(node_ms[False]),
                             "with_debug_images": min(node_ms[True])},
           "request_ms_jpeg": {"median": statistics.median(req_ms["jpeg"]),
                               "min": min(req_ms["jpeg"]), "max": max(req_ms["jpeg"])},
           "request_ms_png": {"median": statistics.median(req_ms["png"]),
                              "min": min(req_ms["png"]), "max": max(req_ms["png"])},
           "analyze_ms": {"median": statistics.median(analyze_ms), "min": min(analyze_ms),
                          "max": max(analyze_ms)},
           "launches_per_request": counts, "mismatches": mismatches, "card": smi}
    print(json.dumps({"web_ui": row}), flush=True)
    print(f"   web UI on {smi}: POST /analyze {row['request_ms_jpeg']['median']:.1f} ms (JPEG), "
          f"{row['request_ms_png']['median']:.1f} ms (PNG), analyze() "
          f"{row['analyze_ms']['median']:.1f} ms; eval JPEG decode "
          f"{inputs['eval_jpeg_ms_per_image']:.2f} ms, photo "
          f"{inputs['photo_jpeg_ms']:.1f} ms", flush=True)
    if mismatches:
        raise AssertionError(f"web UI responses differ from analyze() / core.viz: {mismatches}")
    ANALYZE_MS["trained-product"] = analyze_ms
    return counts


#: the black-box VLM value pass: the trained product's first VLM_IMAGES
#: eval images, chunks of VLM_BATCH for analyze_many
VLM_IMAGES, VLM_BATCH = 16, 8


def replayed_directions(canned):
    """What a stub that replays an eval label file's directions answers
    by the prompt it is sent — the first voltage class's direction for
    the voltage prompt, the first diode class's for the diode prompt — and
    the FakeVLMClient directions that give the same answers."""
    from circuitvision_tpu_torch.core import taxonomy

    answers = {}
    for kind, classes in (("voltage", taxonomy.VOLTAGE_CLASSES),
                          ("diode", taxonomy.DIODE_CLASSES)):
        answers[kind] = next((tuple(v) for k, v in canned.get("directions", {}).items()
                              if k in classes), ("UNKNOWN", "UNKNOWN"))
    fake = {c: answers["voltage"] for c in taxonomy.VOLTAGE_CLASSES}
    fake.update({c: answers["diode"] for c in taxonomy.DIODE_CLASSES})
    return answers, fake


def vlm_stub():
    """A Gemini and OpenRouter stand-in on 127.0.0.1, served from a
    thread: it answers the labels of `stub.canned` (the label file of the
    image being read) and directions by the prompt's kind, and records
    each request's path, body and seconds to answer."""
    import http.server
    import threading

    from circuitvision_tpu_torch.enrich import prompts

    class Handler(http.server.BaseHTTPRequestHandler):
        disable_nagle_algorithm = True  # headers and body in two writes: no delayed-ACK stall

        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            canned = server.canned
            if self.path.endswith("/chat/completions"):
                out = {"choices": [{"index": 0, "message": {
                    "role": "assistant", "content": json.dumps(canned["labels"])}}]}
            else:
                parts = body["contents"][0]["parts"]
                if parts[-1] == {"text": prompts.LABELS_PROMPT}:
                    text = json.dumps(canned["labels"])
                else:
                    kind = ("voltage" if parts[0]["text"] == prompts.VOLTAGE_DIRECTION_PROMPT
                            else "diode")
                    direction, reason = replayed_directions(canned)[0][kind]
                    text = json.dumps({"direction": direction, "reason": reason})
                out = {"candidates": [{"content": {"parts": [{"text": text}], "role": "model"}}]}
            data = json.dumps(out).encode()
            server.requests.append((self.path, body))
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    server.canned, server.requests = None, []
    server.url = f"http://127.0.0.1:{server.server_address[1]}"
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def run_value_pass(torch, smi):
    """Phase 8e: the black-box VLM value pass on the trained product (see
    the module docstring). Returns the launches of one analyze()."""
    import base64
    import hashlib
    import statistics
    import tempfile

    from circuitvision_tpu_torch.enrich.client import (
        FakeVLMClient, GeminiVLMClient, OpenRouterVLMClient,
    )
    from circuitvision_tpu_torch.eval.metrics import netlist_exact_match
    from circuitvision_tpu_torch.io.image_io import decode_image, load_image
    from circuitvision_tpu_torch.models.bridge import state_dict_from_variables
    from circuitvision_tpu_torch.models.checkpoint import load_model_checkpoint
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch
    from circuitvision_tpu_torch.topology.enumerate_components import enumerate_components

    (yv, ymeta), (sv, smeta) = (load_model_checkpoint(str(REPO / "ckpt" / k))
                                for k in ("yolo", "sam2"))
    ystate, sstate = state_dict_from_variables(yv), state_dict_from_variables(sv)
    cfg = product_config(ymeta, smeta)
    data = REPO / "eval_data"
    paths = sorted((data / "images").glob("*.png"))[:VLM_IMAGES]
    images = [load_image(str(p)) for p in paths]
    canned = [json.loads((data / "labels" / f"{p.stem}.json").read_text()) for p in paths]
    reset, read = counters()
    stub = vlm_stub()
    analyzer = CircuitAnalyzerTorch(cfg, ystate, sstate, device="cuda",
                                    vlm_client=FakeVLMClient())

    def run(client_of, reads=None):
        """analyze() + generate_final_netlist of every image with the
        client `client_of(i)`: results, ms per image, launches of each."""
        results, ms = [], []
        for i, img in enumerate(images):
            analyzer.vlm_client, stub.canned = client_of(i), canned[i]
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = analyzer.generate_final_netlist(analyzer.analyze(img))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            counts = read()
            if counts != EXPECTED["t@512"]:
                raise AssertionError(f"value pass, {paths[i].stem}: launches per analyze "
                                     f"{counts} != {EXPECTED['t@512']}")
            results.append(r)
        return results, ms, counts

    run(lambda i: FakeVLMClient(canned[i]["labels"], replayed_directions(canned[i])[1]))  # warm-up
    gemini = GeminiVLMClient(api_key="stub", endpoint=stub.url)
    openrouter = OpenRouterVLMClient(api_key="stub", endpoint=stub.url + "/api/v1")
    rows, gates = {}, {}
    for name, client, fake_dirs in (("gemini", gemini, True), ("openrouter", openrouter, False)):
        fakes, fake_ms, _ = run(lambda i: FakeVLMClient(
            canned[i]["labels"], replayed_directions(canned[i])[1] if fake_dirs else {}))
        stub.requests = []
        got, got_ms, launches = run(lambda i: client)
        sent = [b for p, b in stub.requests if p.endswith("/chat/completions")
                or p.endswith(f"/{gemini.labels_model}:generateContent")]
        pngs = [b["messages"][0]["content"][1]["image_url"]["url"].split(",", 1)[1]
                if "messages" in b else b["contents"][0]["parts"][0]["inlineData"]["data"]
                for b in sent]
        decode = base64.b64decode if name == "openrouter" else base64.urlsafe_b64decode
        drawn = [r for r in got if r.enum_image is not None]
        stub_png_equal = len(pngs) == len(drawn) and all(
            decode_image(decode(b)).tobytes() == r.enum_image.tobytes()
            for b, r in zip(pngs, drawn))
        redrawn_equal = True
        draw_ms = []
        for r in drawn:
            t0 = time.perf_counter()
            again, ids = enumerate_components(r.image_for_analysis, r.bboxes)
            draw_ms.append((time.perf_counter() - t0) * 1e3)
            redrawn_equal &= (again.tobytes() == r.enum_image.tobytes() and
                              [b.to_dict() for b in ids] == [b.to_dict() for b in r.enum_bboxes])
        labels_ms = []
        for r, c in zip(got, canned):
            if r.enum_image is not None:
                stub.canned = c
                t0 = time.perf_counter()
                client.get_labels(r.enum_image)
                labels_ms.append((time.perf_counter() - t0) * 1e3)
        direction_ms = []
        for r in got:
            for b in r.bboxes:
                crop = r.vlm_direction_crops.get(b.persistent_uid)
                if crop is not None and name == "gemini":
                    t0 = time.perf_counter()
                    client.get_direction(crop, b.class_name)
                    direction_ms.append((time.perf_counter() - t0) * 1e3)
        refs = [(data / "netlists" / f"{p.stem}.cir") for p in paths]
        have = [i for i, f in enumerate(refs) if f.exists()]
        netlists_equal = [f.netlist_text == g.netlist_text for f, g in zip(fakes, got)]
        rows[name] = {
            "analyze_final_ms_per_image": {"median": statistics.median(got_ms), "min": min(got_ms),
                                           "max": max(got_ms)},
            "fake_analyze_final_ms_per_image": statistics.median(fake_ms),
            "enumeration_draw_ms_per_image": {"median": statistics.median(draw_ms),
                                              "max": max(draw_ms), "images": len(draw_ms)},
            "labels_round_trip_ms": {"median": statistics.median(labels_ms),
                                     "max": max(labels_ms)},
            "direction_round_trip_ms": ({"median": statistics.median(direction_ms),
                                         "max": max(direction_ms), "calls": len(direction_ms)}
                                        if direction_ms else None),
            "requests": len(stub.requests), "launches_per_analyze": launches,
            "netlists_equal_fake": sum(netlists_equal), "stub_png_equal": stub_png_equal,
            "enumeration_redrawn_equal": redrawn_equal,
            "netlist_exact_match": netlist_exact_match([got[i].netlist_text for i in have],
                                                       [refs[i].read_text() for i in have]),
            "netlists_compared": len(have)}
        gates[name] = all(netlists_equal) and stub_png_equal and redrawn_equal and bool(drawn)
        print(json.dumps({f"vlm_value_pass_{name}": {**rows[name], "card": smi}}), flush=True)

    # analyze_many(finalize=True): a fake replaying each image's values,
    # found by its enumeration image, and one set of directions
    directions = {}
    for c in canned:
        directions.update({k: v for k, v in replayed_directions(c)[1].items()
                           if k not in directions})

    class ReplayByImage(FakeVLMClient):
        def __init__(self, by_image):
            super().__init__(None, directions)
            self.by_image = by_image

        def get_labels(self, enum_image):
            self.label_calls += 1
            return list(self.by_image[hashlib.sha256(enum_image.tobytes()).hexdigest()])

        def get_labels_batch(self, enum_images):
            self.label_batch_calls += 1
            return [self.get_labels(e) for e in enum_images]

    serial, _, _ = run(lambda i: FakeVLMClient(canned[i]["labels"], directions))
    by_image = {hashlib.sha256(r.enum_image.tobytes()).hexdigest(): c["labels"]
                for r, c in zip(serial, canned) if r.enum_image is not None}
    analyzer.vlm_client = ReplayByImage(by_image)
    analyzer.analyze_batch(images[:VLM_BATCH], batch_size=VLM_BATCH, finalize=True)  # warm-up
    analyzer.vlm_client = client = ReplayByImage(by_image)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched = analyzer.analyze_batch(images, batch_size=VLM_BATCH, finalize=True)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    batch_counts = read()
    chunks = -(-len(images) // VLM_BATCH)
    want = {k: v * chunks for k, v in EXPECTED["t@512"].items()}
    batch_differ = [p.stem for p, b, r in zip(paths, batched, serial)
                    if b.netlist_text != r.netlist_text or (b.enum_image is None) != (
                        r.enum_image is None) or (b.enum_image is not None and
                                                 b.enum_image.tobytes() != r.enum_image.tobytes())]
    print(json.dumps({"vlm_value_pass_batched": {
        "images_per_s": len(images) / batch_s, "batch_size": VLM_BATCH,
        "label_batch_calls": client.label_batch_calls, "launches": batch_counts,
        "differing_from_serial": batch_differ, "card": smi}}), flush=True)

    # the eval script over the whole eval set, in a process
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "scripts/torch_eval_pipeline.py", "--data",
                               "eval_data", "--yolo-checkpoint", "ckpt/yolo",
                               "--sam2-checkpoint", "ckpt/sam2", "--out", f"{tmp}/report.json"],
                              cwd=REPO, capture_output=True, text=True, timeout=600)
        eval_s = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"torch_eval_pipeline.py failed ({proc.returncode}):\n"
                                 f"{proc.stderr[-3000:]}")
        report = json.loads(Path(f"{tmp}/report.json").read_text())
    print(json.dumps({"torch_eval_pipeline": {
        "mode": "full model, ckpt/yolo + ckpt/sam2 (float32), eval_data/labels replayed",
        "seconds": eval_s, "report": report, "card": smi}}), flush=True)
    stub.shutdown()
    stub.server_close()

    ms = {k: rows[k]["analyze_final_ms_per_image"]["median"] for k in rows}
    print(f"   value pass on {smi}: analyze()+final {ms['gemini']:.1f} ms/image with Gemini, "
          f"{ms['openrouter']:.1f} with OpenRouter (stub on 127.0.0.1); eval script "
          f"{eval_s:.1f} s over {report['images']} images", flush=True)
    if not all(gates.values()):
        raise AssertionError(f"value pass: HTTP netlists, the stub's PNGs or the redrawn "
                             f"enumeration differ: {rows}")
    if batch_counts != want or batch_differ:
        raise AssertionError(f"value pass batched: launches {batch_counts} != {want}, or "
                             f"netlists differ from serial on {batch_differ}")
    if report.get("images") != 63 or "netlist_exact_match" not in report:
        raise AssertionError(f"torch_eval_pipeline.py's report: {report}")
    return launches


def run_flops(torch, smi):
    """The FLOP count (models/flops.py, FlopCounterMode over the module
    path on the meta device) of one trained-product analyze() (YOLOv11-s@640
    + SAM2 Hiera-t@512), one L@1024 analyze() (YOLOv11-s@640 + the
    default SAM2Config) and one reference-deployment analyze()
    (PipelineConfig(): YOLOv11-l@640 + the default SAM2Config), and the
    rate each implies at this run's analyze() times against the card's
    peak (flops.device_peak_flops)."""
    import statistics

    from circuitvision_tpu_torch.core.config import DetectorConfig, SAM2Config
    from circuitvision_tpu_torch.models import flops
    from circuitvision_tpu_torch.models.bridge import detector_config, sam2_config

    ymeta = json.loads((REPO / "ckpt" / "yolo" / "meta.json").read_text())
    smeta = json.loads((REPO / "ckpt" / "sam2" / "meta.json").read_text())
    det = detector_config(ymeta)
    rows = {}
    for name, dcfg, scfg, path, dtype in (
            ("trained_product", det, sam2_config(smeta), "trained-product", torch.float32),
            ("l@1024", det, SAM2Config(), "l@1024", torch.bfloat16),
            ("reference", DetectorConfig(), SAM2Config(), "reference", torch.bfloat16)):
        yolo, sam2 = flops.yolo_forward_flops(dcfg), flops.sam2_forward_flops(scfg)
        ms = statistics.median(ANALYZE_MS[path])
        peak = flops.device_peak_flops("cuda", dtype)
        rows[name] = {"yolo_flops": yolo, "sam2_flops": sam2, "total_flops": yolo + sam2,
                      "analyze_ms": ms, "tflops_per_s": (yolo + sam2) / ms / 1e9,
                      "peak_dtype": str(dtype), "peak_tflops_per_s": peak / 1e12,
                      "share_of_peak": (yolo + sam2) / (ms / 1e3) / peak}
    print(json.dumps({"flops": {**rows, "card": smi}}), flush=True)


def run_trunk_ln_path(torch):
    """The trunk LayerNorm option: TrunkLayerNorm(fused=True) at the four
    Hiera-L@1024 trunk shapes in bfloat16, each called alone and with
    residual=, against the same module unfused. Returns the launches."""
    from circuitvision_tpu_torch.models.sam2.hiera import TrunkLayerNorm

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for t, c in L_TRUNK_ROWS:
        side = int(math.isqrt(t))
        m = TrunkLayerNorm(c, fused=True).cuda()
        with torch.no_grad():
            m.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen, device="cuda"))
            m.bias.copy_(0.1 * torch.randn(c, generator=gen, device="cuda"))
        x, r = (torch.randn(1, side, side, c, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        cases.append((m, x, r))
    reset, read = counters()
    reset()
    torch.cuda.synchronize()
    with torch.no_grad():
        outs = [(m(x), m(x, residual=r)) for m, x, r in cases]
    torch.cuda.synchronize()
    counts = read()
    if counts != EXPECTED["trunk-ln"]:
        raise AssertionError(f"trunk-ln: launches {counts} != {EXPECTED['trunk-ln']}")
    for (m, x, r), (y, (resid, y2)) in zip(cases, outs):
        m.fused = False
        with torch.no_grad():
            ref, (ref_resid, ref2) = m(x), m(x, residual=r)
        errs = [float((a.float() - b.float()).abs().max()) for a, b in ((y, ref), (y2, ref2))]
        tol = tolerance("bfloat16", float(ref.float().abs().max()))
        if max(errs) > tol or not torch.equal(resid, ref_resid):
            raise AssertionError(f"TrunkLayerNorm(fused=True) C={x.shape[-1]}: {errs} > {tol}")
        print(json.dumps({"trunk_ln_option": list(x.shape), "max_abs_err": errs, "tol": tol}),
              flush=True)
    return counts


def train_inputs(torch, batch: int, res: int, seed: int = 0):
    """scripts/profile_train_step.py's seeded batch: uniform images and
    masks of density 1/2, on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    images = rng.random((batch, res, res, 3), np.float32)
    masks = (rng.random((batch, res, res)) > 0.5).astype(np.float32)
    return torch.from_numpy(images).cuda(), torch.from_numpy(masks).cuda()


def train_model(torch, meta, state, device, dtype):
    """A SAM2ImageSegmenter of `meta` with `state`, every float leaf in
    `dtype` — LayerNorm parameters too, as the JAX training config casts
    them (scripts/profile_train_step.py)."""
    from circuitvision_tpu_torch.models.bridge import sam2_config
    from circuitvision_tpu_torch.models.sam2.wrapper import SAM2ImageSegmenter

    m = SAM2ImageSegmenter(sam2_config(meta, dtype=str(dtype).removeprefix("torch.")))
    m.load_state_dict(state)
    return m.to(device=device, dtype=dtype)


def run_steps(torch, smi, name, step, carry, batch, steps, expected, fixed=True):
    """One warm-up and `steps` timed steps of `step(carry, images, masks)
    → (carry, metrics)`, on one batch (`fixed`) or on each of `batch`'s
    batches in turn; launches of the first timed step held to
    EXPECTED[expected]; ms per step (median), images/s, peak memory
    (torch.cuda.max_memory_allocated over the steps, beside what was
    allocated before them) and the losses printed. Returns (report,
    launches)."""
    import statistics

    reset, read = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # the model's weights and what earlier phases hold
    losses, times, counts = [], [], None
    for i in range(1 + steps):
        images, masks = batch if fixed else next(batch)
        if i == 1:
            reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, metrics = step(carry, images, masks)
        losses.append(float(metrics["loss"]))  # reads back: the step has ended
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 1:
            counts = read()
    n = images.shape[0]
    ms = statistics.median(times[1:])
    report = {"name": name, "batch": n, "ms_per_step": ms, "step_ms": times[1:],
              "warmup_ms": times[0], "images_per_s": n / (ms * 1e-3),
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "allocated_before_gib": base / 2 ** 30,
              "losses": losses, "launches": counts, "card": smi}
    print(json.dumps({"train_path": report}), flush=True)
    if counts != EXPECTED[expected]:
        raise AssertionError(f"{name}: launches per step {counts} != {EXPECTED[expected]}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: losses {losses}")
    if fixed and not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall over {steps} steps on one batch: "
                             f"{losses}")
    return report, counts


def run_training(torch, smi):
    """Phase 12: the SAM2 fine-tune. (1) L_CUT whole-tree in float32, TF32
    off: the card's gradients (FlashAttention's kernels in the global
    block) against the port's CPU gradients, every leaf. (2) SAM2.1-L@1024
    in bfloat16, seeded weights, on one seeded batch: the whole-tree step
    at batch 1 and 4 (path A), the selective step at the reference's
    surface and the rank-4 LoRA step at batch 4 (path B); SAM2.1
    Hiera-t@1024 in bfloat16, seeded, its whole-tree step at batch 1 and 4
    (global heads of 96). (3) The shipped segmenter's fine-tune (path C):
    ckpt/sam2 (t@512 float32), every leaf trained at
    scripts/train_segmenter.py's learning rate held constant, batches of 8
    from eval_data through the port's SegmentationFolderDataset. Returns
    the launches per step of path A and of the t@1024 step at batch 1."""
    from circuitvision_tpu_torch.core.config import TrainConfig
    from circuitvision_tpu_torch.models.bridge import (
        sam2_config, seeded_state, state_dict_from_variables,
    )
    from circuitvision_tpu_torch.models.checkpoint import load_model_checkpoint
    from circuitvision_tpu_torch.train import lora
    from circuitvision_tpu_torch.train import train_step as ts
    from circuitvision_tpu_torch.train.data import SegmentationFolderDataset

    def params_of(model):
        return {n: p.detach() for n, p in model.named_parameters()}

    def stepper(model, cfg, mask, selective):
        """(step over carry = (params, optimizer state), its first carry)."""
        opt, mask = ts.make_optimizer(model, cfg, mask)
        train_step = ts.make_train_step(model, opt, cfg, mask, selective)

        def step(carry, images, masks):
            params, state, metrics = train_step(*carry, images, masks)
            return (params, state), metrics

        params = params_of(model)
        return step, (params, opt.init(params))

    def every_leaf(model):
        return {n: True for n, _ in model.named_parameters()}

    # (1) card against CPU gradients at L_CUT
    cut = {"sam2": {"preset": "l", "overrides": L_CUT}}
    state = seeded_state("sam2", cut, 7)
    images, masks = train_inputs(torch, 1, 1024, seed=1)
    card = train_model(torch, cut, state, "cuda", torch.float32)
    reset, read = counters()
    reset()
    _l, _m, got = ts.loss_and_grads(card, params_of(card), images, masks, selective=False)
    torch.cuda.synchronize()
    counts = read()
    t0 = time.perf_counter()
    cpu = train_model(torch, cut, state, "cpu", torch.float32)
    _l, _m, ref = ts.loss_and_grads(cpu, params_of(cpu), images.cpu(), masks.cpu(),
                                    selective=False)
    cpu_s = time.perf_counter() - t0
    worst = _worst_leaf(got, ref)
    print(json.dumps({"train_lcut_f32_card_vs_cpu": {
        "leaves": len(ref), "worst_leaf": worst[2], "max_abs_err": worst[0],
        "max_abs_cpu": worst[1], "tol": TRAIN_RTOL * max(1.0, worst[1]),
        "cpu_seconds": cpu_s, "launches": counts, "card": smi}}), flush=True)
    if counts != EXPECTED["train-lcut"]:
        raise AssertionError(f"L_CUT: launches {counts} != {EXPECTED['train-lcut']}")
    if not all(bool(torch.isfinite(g).all()) for g in got.values()) \
            or worst[0] > TRAIN_RTOL * max(1.0, worst[1]):
        raise AssertionError(f"L_CUT card gradients differ from the CPU's: {worst}")
    del card, cpu, got, ref

    # (2) SAM2.1-L@1024 in bfloat16, full depth
    meta = {"sam2": {"preset": "l", "overrides": {}}}
    model = train_model(torch, meta, seeded_state("sam2", meta, 2), "cuda", torch.bfloat16)
    cfg = TrainConfig()
    for batch in (1, 4):  # 4, the profile script's default, fits in 80 GB (PERF.md §6)
        step, carry = stepper(model, cfg, every_leaf(model), selective=False)
        _report, counts = run_steps(torch, smi, "A: whole-tree L@1024 bf16", step, carry,
                                    train_inputs(torch, batch, 1024), TRAIN_STEPS, "train-whole")
        if batch == 1:
            launches = counts
        del step, carry
        torch.cuda.empty_cache()
    inputs = train_inputs(torch, 4, 1024)
    step, carry = stepper(model, cfg, None, selective=True)  # the reference's surface
    run_steps(torch, smi, "B: selective L@1024 bf16 (cutoff 44)", step, carry, inputs,
              TRAIN_STEPS, "train-selective")
    del step, carry
    torch.cuda.empty_cache()
    tstate = lora.init_train_state(model, torch.Generator().manual_seed(0), cfg)
    lopt = lora.make_lora_optimizer(cfg)
    lora_step = lora.make_lora_train_step(model, lopt, cfg)
    base = params_of(model)

    def lstep(carry, images, masks):
        tstate, state, metrics = lora_step(base, *carry, images, masks)
        return (tstate, state), metrics

    run_steps(torch, smi, "B: LoRA rank 4 alpha 16 L@1024 bf16", lstep,
              (tstate, lopt.init(lora.flat_names(tstate))), inputs, TRAIN_STEPS, "train-lora")
    del model, base, tstate, inputs
    torch.cuda.empty_cache()

    # Hiera-t@1024 in bfloat16: FlashAttention at head width 96
    meta = {"sam2": {"preset": "t", "overrides": {"resolution": 1024}}}
    model = train_model(torch, meta, seeded_state("sam2", meta, 5), "cuda", torch.bfloat16)
    for batch in (1, 4):
        step, carry = stepper(model, cfg, every_leaf(model), selective=False)
        _report, counts = run_steps(torch, smi, "t@1024 whole-tree bf16", step, carry,
                                    train_inputs(torch, batch, 1024), TRAIN_STEPS, "train-whole")
        if batch == 1:
            launches_t = counts
        del step, carry
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()

    # (3) the shipped segmenter's fine-tune
    variables, smeta = load_model_checkpoint(str(REPO / "ckpt" / "sam2"))
    scfg = sam2_config(smeta)
    model = train_model(torch, smeta, state_dict_from_variables(variables), "cuda",
                        getattr(torch, scfg.dtype))
    ds = SegmentationFolderDataset(str(REPO / "eval_data"), resolution=scfg.resolution,
                                   device="cuda")
    step, carry = stepper(model, TrainConfig(learning_rate=5e-4), every_leaf(model),
                          selective=False)
    batches = ds.batches(8, seed=0, epochs=None)
    report, _ = run_steps(torch, smi, "C: shipped t@512 f32 fine-tune, eval_data", step, carry,
                          batches, TRAIN_C_STEPS, "train-c", fixed=False)
    batches.close()
    print(json.dumps({"train_c_loss": {"first": report["losses"][0],
                                       "last": report["losses"][-1], "images": len(ds)}}))
    del model
    torch.cuda.empty_cache()
    return launches, launches_t


def run_batched_path(torch, smi):
    """The batched entry point at YOLOv11-s@640 + SAM2 Hiera-t@512 (seeded
    weights; SAM2 in float32 as its meta says) with use_fused_morphology
    on, over BATCH_IMAGES drawings of varied seeds and sizes in chunks of
    BATCH_SIZE: (a) analyze_many against the card's own analyze() on each
    image; (b) the drawn topology — each drawing's drawn boxes in place of
    detection, the classical mask — on the card with the switch on and
    off and on the CPU with it on; (c) exact launch counts, the line
    enhancement once per image with a mask; (d) images/s of analyze_many
    against serial analyze(). Returns the launches of one analyze_many()
    (the line enhancement's from the drawn topology on the card with the
    switch on) and the raster shapes the line enhancement ran at in that
    run ({(h, w): launches}) and in the seeded-weight run."""
    import copy

    import numpy as np

    from circuitvision_tpu_torch.core.config import PipelineConfig, TopologyConfig
    from circuitvision_tpu_torch.core.types import BBox
    from circuitvision_tpu_torch.models.bridge import detector_config, sam2_config, seeded_state
    from circuitvision_tpu_torch.pipeline import batch as tbatch
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch
    from circuitvision_tpu_torch.topology import nodes as tnodes
    from circuitvision_tpu_torch.topology.crop import crop_image_and_adjust_bboxes
    from circuitvision_tpu_torch.topology.reclassify import segment_classical

    ymeta = json.loads((REPO / "ckpt" / "yolo" / "meta.json").read_text())
    smeta = json.loads((REPO / "ckpt" / "sam2" / "meta.json").read_text())
    on, off = TopologyConfig(use_fused_morphology=True), TopologyConfig()
    cfg = PipelineConfig(detector=detector_config(ymeta), sam2=sam2_config(smeta), topology=on)
    describe(cfg)
    ystate, sstate = seeded_state("yolo", ymeta, 0), seeded_state("sam2", smeta, 1)
    drawings = batch_drawings()
    images = [img for img, _ in drawings]
    card = CircuitAnalyzerTorch(cfg, ystate, sstate, device="cuda")
    reset, read = counters()

    # the raster shapes the line enhancement runs at, for its kernel phase
    seeded_shapes: dict = {}
    drawn_shapes: dict = {}
    launch = tnodes.enhance_lines_fused

    def recording(shapes):
        def record(x):
            shapes[tuple(x.shape)] = shapes.get(tuple(x.shape), 0) + 1
            return launch(x)
        return record

    card.analyze_batch(images[:BATCH_SIZE], batch_size=BATCH_SIZE)  # warm-up
    tnodes.enhance_lines_fused = recording(seeded_shapes)
    try:
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batched = card.analyze_batch(images, batch_size=BATCH_SIZE)
        torch.cuda.synchronize()
        t_batch = time.perf_counter() - t0
        counts = read()
    finally:
        tnodes.enhance_lines_fused = launch
    with_mask = sum(r.sam_mask is not None for r in batched)
    print(json.dumps({"path": "batch", "images": len(images), "batch_size": BATCH_SIZE,
                      "launches": counts, "images_with_mask": with_mask}), flush=True)
    if counts != EXPECTED["batch"] or counts["enhance_lines_fused"] != with_mask:
        raise AssertionError(f"batch: launches {counts} != {EXPECTED['batch']} "
                             f"({with_mask} images with a mask)")

    card.analyze(images[0])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    singles = [card.analyze(img) for img in images]
    torch.cuda.synchronize()
    t_serial = time.perf_counter() - t0

    key = lambda r: [(b.class_name, b.xmin, b.ymin, b.xmax, b.ymax) for b in r.bboxes_orig_nms]  # noqa: E731
    worst, mismatches = 1.0, []
    for i, (b, s) in enumerate(zip(batched, singles)):
        agree = float(np.mean(b.sam_mask == s.sam_mask)) \
            if b.sam_mask.shape == s.sam_mask.shape else 0.0
        worst = min(worst, agree)
        if key(b) != key(s) or len(b.nodes) != len(s.nodes) or b.netlist_text != s.netlist_text \
                or agree < MASK_AGREEMENT_MIN:
            mismatches.append({"drawing": i, "boxes": [key(b), key(s)],
                               "nodes": [len(b.nodes), len(s.nodes)],
                               "netlist_equal": b.netlist_text == s.netlist_text, "mask": agree})

    # (b) the drawn topology: detection replaced by the drawn boxes, no SAM2
    gt = {id(img): [BBox("resistor", 1.0, *bx, class_id=10) for bx in boxes]
          for img, boxes in drawings}
    detect = tbatch.BatchedPipeline._detect_bboxes
    tbatch.BatchedPipeline._detect_bboxes = \
        lambda self, chunk, imgs_dev: [copy.deepcopy(gt[id(im)]) for im in chunk]
    runs = {}
    try:
        for name, topo, dev in (("card_on", on, "cuda"), ("card_off", off, "cuda"),
                                ("cpu_on", on, "cpu")):
            a = CircuitAnalyzerTorch(dataclasses.replace(cfg, topology=topo), ystate, None,
                                     device=dev)
            if name == "card_on":
                tnodes.enhance_lines_fused = recording(drawn_shapes)
            reset()
            rs = a.analyze_batch(images, batch_size=BATCH_SIZE)
            runs[name] = ([(len(r.nodes), r.netlist_text) for r in rs],
                          read()["enhance_lines_fused"])
            tnodes.enhance_lines_fused = launch
    finally:
        tbatch.BatchedPipeline._detect_bboxes = detect
        tnodes.enhance_lines_fused = launch
    grey = 0
    for img, boxes in drawings:
        crop, bxs, _info = crop_image_and_adjust_bboxes(img, gt[id(img)], cfg.crop)
        mask = segment_classical(crop, on, device="cuda")
        emptied = torch.as_tensor(tnodes.subtract_component_boxes(mask, bxs), device="cuda")
        h, w = emptied.shape
        resized = tnodes._cv2_resize_u8(emptied.float(), (on.resize_height,
                                                          int(on.resize_height * (w / h))))
        grey += int((tnodes.enhance_chain(resized, on) != tnodes.enhance_chain(resized, off)).sum())
    drawn = {"netlists_equal": runs["card_on"][0] == runs["card_off"][0] == runs["cpu_on"][0],
             "nodes": [n for n, _ in runs["card_on"][0]],
             "enhance_lines_fused_launches": {k: v[1] for k, v in runs.items()},
             "raster_shapes_card_on": {f"{h}x{w}": n for (h, w), n in drawn_shapes.items()},
             "grey_levels_differing_on_vs_off": grey}
    ips_batch, ips_serial = len(images) / t_batch, len(images) / t_serial
    print(json.dumps({"batched_vs_analyze": {
        "mismatches": mismatches, "worst_mask_agreement": worst,
        "drawn_topology": drawn,
        "images_per_s": {"analyze_many": ips_batch, "serial_analyze": ips_serial},
        "seconds": {"analyze_many": t_batch, "serial_analyze": t_serial},
        "card": smi}}), flush=True)
    print(f"   images/s on {smi}: analyze_many {ips_batch:.2f}, serial analyze() "
          f"{ips_serial:.2f}", flush=True)
    if mismatches:
        raise AssertionError(f"analyze_many differs from analyze() on {len(mismatches)} drawings")
    if not drawn["netlists_equal"] or min(drawn["nodes"]) < 2:
        raise AssertionError(f"drawn topology: {drawn} / {runs}")
    if runs["card_on"][1] != len(images) or runs["card_off"][1] or runs["cpu_on"][1]:
        raise AssertionError(f"drawn topology launches: {drawn['enhance_lines_fused_launches']}")
    return {**counts, "enhance_lines_fused": runs["card_on"][1]}, (drawn_shapes, seeded_shapes)


#: sha256 (pool_item_digest) of pool items as the JAX package's
#: scripts/gen_pool.py renders them (handdrawn 0.25, degrade 0.40):
#: schematic, jpeg, wobble, handdrawn, blur, shadow and perspective items.
#: tests/test_torch_port_eval.py holds them to the JAX renders.
POOL_ITEM_DIGESTS = {
    100000: "fa1d3bd854e773ca10acf704cc3b3899bcaab6781fbb6a138fed3b8e8da90025",
    100001: "3f1f8434b9dab6ead870629d9e86a9139d6357028bf3813c749686cc6be83ec1",
    100002: "e9aefe868d49eb4ab32fe33e9eddb87dd942dc6608da643c3ffd1d29a4ee61e9",
    100003: "736a13e7fa00ae28d8a80770f6fa28e075926371c4eafe44ba83ef94577be50a",
    100004: "61945d5173653f688888461afb0768e5b0b9c0015b9c7623d43b81439452c413",
    100016: "9708efcc424d5f2ed4083ddebd68f57dbf1f0f64ed7d589aa94f7623624b14f2",
    100021: "84823f5aef34ecc1094934b735150250a97521753590bf28c982841d9d572880",
    100025: "2822ee7844cbaea45bbaf65d933bf24e762f535142fdf5e1191620be7e0373ef",
}
POOL_SEED0, POOL_ITEMS, POOL_VAL = 100000, 128, 32
DET_STEPS, DET_BATCH, DET_WARMUP, DET_LR = 40, 16, 5, 2e-3
READER_CIRCUITS, READER_STEPS, READER_BATCH, READER_LR, READER_VAL = 64, 60, 256, 3e-4, 16
#: card against CPU gradients of the trainers' steps: 1e-3 × max(1, max |cpu|)
#: per leaf, as the L_CUT fine-tune's (TRAIN_RTOL); the loss within 1e-4
TRAINER_LOSS_RTOL = 1e-4


def pool_item_digest(item, hashlib) -> str:
    """sha256 over a pool item's arrays in key order (name, dtype, shape,
    bytes)."""
    import numpy as np

    h = hashlib.sha256()
    for k in sorted(item):
        a = np.asarray(item[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _worst_leaf(got, ref):
    """(max |card − cpu|, max |cpu|, leaf) of the leaf worst against its
    bound 1e-3 · max(1, max |cpu|)."""
    return max(((float((got[n].cpu() - r).abs().max()), float(r.abs().max()), n)
                for n, r in ref.items()), key=lambda e: e[0] / max(1.0, e[1]))


def step_split(torch, model, params, tx, opt_state, loss_of_heads, x, steps=5):
    """Where a trainer's step goes: host ms (synchronised, median of
    `steps`) of the forward, the loss (with the assignment), the backward
    and the optimizer's update with its apply, on one batch."""
    import statistics

    from circuitvision_tpu_torch.train import optim

    parts = {"forward": [], "loss": [], "backward": [], "update": []}
    for _ in range(steps + 1):
        leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        torch.cuda.synchronize()
        marks = [time.perf_counter()]
        heads = torch.func.functional_call(model, leaves, (x,))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        loss = loss_of_heads(heads)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n] for n in names],
                                                    allow_unused=True)))
        grads = {n: g if g is not None else torch.zeros_like(params[n]) for n, g in grads.items()}
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        updates, _state = tx.update(grads, opt_state, params)
        optim.apply_updates(params, updates)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for k, a, b in zip(parts, marks, marks[1:]):
            parts[k].append(1e3 * (b - a))
    return {f"{k}_ms": statistics.median(v[1:]) for k, v in parts.items()}


def saved_trained_model(torch, smi, kind, out, image=None):
    """A trained detector or reader written as the JAX trainers write it
    (yolo_train.save_detector: orbax + meta.json; reader.save_reader: a
    bare orbax directory), read back by load_model_checkpoint, equal leaf
    for leaf to the in-memory weights; for the detector, an analyzer from
    the written checkpoint gives `image` the heads of one from the
    in-memory parameters."""
    import tempfile

    import numpy as np

    from circuitvision_tpu_torch.core.config import PipelineConfig
    from circuitvision_tpu_torch.models import bridge
    from circuitvision_tpu_torch.models.checkpoint import load_model_checkpoint
    from circuitvision_tpu_torch.models.yolo.decode import STRIDES
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch
    from circuitvision_tpu_torch.train import reader as rt
    from circuitvision_tpu_torch.train import yolo_train as yt

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/{kind}"
        t0 = time.perf_counter()
        if kind == "detector":
            yt.save_detector(path, out, scale="s", img_size=640, steps=DET_STEPS,
                             batch=DET_BATCH, pool="chip_smoke_pool")
        else:
            rt.save_reader(path, out)
        write_s = time.perf_counter() - t0
        nbytes = _dir_bytes(path)
        t0 = time.perf_counter()
        got, meta = load_model_checkpoint(path)
        read_s = time.perf_counter() - t0
    leaves = _same_tree(np, f"the written {kind}", got,
                        bridge.variables_from_state_dict(out["params"], out["model"]))
    row = {"kind": kind, "write_s": write_s, "bytes_written": nbytes, "read_s": read_s,
           "leaves": leaves, "meta": meta}
    if kind == "detector":
        det = dataclasses.replace(bridge.detector_config(meta), dtype="float32")
        cfg = PipelineConfig(detector=det, use_sam2=False)
        heads = [CircuitAnalyzerTorch(cfg, state, None, device="cuda").yolo_heads(image)[0]
                 for state in (bridge.state_dict_from_variables(got),
                               {n: t.detach() for n, t in out["params"].items()})]
        row["heads_written_vs_in_memory"] = {
            f"stride{s}": path_err(torch, f"written detector head, stride {s}", g, r.cpu())
            for s, g, r in zip(STRIDES, *heads)}
        if meta["detector"] != {"scale": "s", "img_size": 640, "num_classes": det.num_classes,
                                "reg_max": 16} or meta["kind"] != "yolo":
            raise AssertionError(f"the written detector's meta: {meta}")
    print(json.dumps({"trained_model_written": {**row, "card": smi}}), flush=True)


def eval_detector_table(smi, pool_dir, out):
    """scripts/torch_eval_detector.py as a process on the pool's held-out
    tail, for the trained detector (written as the JAX trainer writes it;
    its table beside the trainer's own held-out mAP@50) and for the
    shipped ckpt/yolo."""
    from circuitvision_tpu_torch.train import yolo_train as yt

    det = f"{pool_dir}/_detector"
    yt.save_detector(det, out, scale="s", img_size=640, steps=DET_STEPS, batch=DET_BATCH,
                     pool="chip_smoke_pool")
    for name, ckpt in (("trained here", det), ("ckpt/yolo", str(REPO / "ckpt" / "yolo"))):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "scripts/torch_eval_detector.py", "--ckpt", ckpt,
                              "--pool", pool_dir, "--val-n", str(POOL_VAL)],
                             cwd=REPO, capture_output=True, text=True, timeout=600)
        table = run.stdout.splitlines()
        print(json.dumps({"torch_eval_detector": {
            "detector": name, "seconds": time.perf_counter() - t0, "table": table,
            **({"trainer_map50_holdout": out["map"]["final"]["all"]} if ckpt == det else {}),
            "card": smi}}), flush=True)
        if run.returncode or not any(line.startswith("mAP@50 all:") for line in table):
            raise AssertionError(f"torch_eval_detector.py on {name} failed ({run.returncode}):\n"
                                 f"{run.stdout[-2000:]}{run.stderr[-3000:]}")


def run_trainers(torch, smi):
    """Phase 13: the pool, the detector's and the reader's training (see
    the module docstring). Raises on any gate."""
    import hashlib
    import statistics
    import tempfile

    import numpy as np

    from circuitvision_tpu_torch.core.taxonomy import TRAIN_CLASSES
    from circuitvision_tpu_torch.eval import pool
    from circuitvision_tpu_torch.models.reader import ReaderConfig
    from circuitvision_tpu_torch.train import reader as rt
    from circuitvision_tpu_torch.train import yolo_loss as yl
    from circuitvision_tpu_torch.train import yolo_train as yt

    reset, read = counters()
    reset()
    print(f"   numpy {np.__version__}")
    # (1) the pool, kept until the detector is scored on its held-out tail
    timings: dict = {}
    pool_dir = tempfile.TemporaryDirectory()  # removed at exit if a gate fails first
    tmp = pool_dir.name
    t0 = time.perf_counter()
    pool.write_pool(tmp, POOL_ITEMS, seed0=POOL_SEED0, log_every=0, timings=timings)
    write_s = time.perf_counter() - t0
    bad = []
    for seed, want in POOL_ITEM_DIGESTS.items():
        with np.load(Path(tmp) / f"{seed - POOL_SEED0:06d}.npz") as z:
            item = {k: z[k] for k in z.files}
        got = pool_item_digest(item, hashlib)
        if got != want:
            bad.append((seed, str(item["tier"]), got))
    t0 = time.perf_counter()
    images, boxes, tiers = pool.load_pool(tmp, 640)
    load_s = time.perf_counter() - t0
    print(json.dumps({"pool": {
        "items": POOL_ITEMS, "write_s": write_s, "letterbox_s": load_s,
        "host_ms_per_item": {k: {"n": len(v), "median": 1e3 * statistics.median(v),
                                 "max": 1e3 * max(v)} for k, v in sorted(timings.items())},
        "digests_checked": len(POOL_ITEM_DIGESTS), "digest_mismatches": bad,
        "card": smi}}), flush=True)
    if bad:
        raise AssertionError(f"pool items differ from the JAX package's renders: {bad}")

    # (2) the detector from random weights
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = yt.train_detector(images, boxes, tiers, scale="s", img_size=640, steps=DET_STEPS,
                            batch=DET_BATCH, lr=DET_LR, warmup_steps=DET_WARMUP,
                            val_n=POOL_VAL, log_every=1, eval_every=0, device="cuda",
                            report=lambda line: print("   " + line, flush=True))
    wall = time.perf_counter() - t0
    hist = out["history"]
    step_ms = [1e3 * (b["seconds"] - a["seconds"]) for a, b in zip(hist, hist[1:])]
    losses = [h["loss"] for h in hist]
    report = {"name": "YOLOv11-s@640 f32 from scratch", "batch": DET_BATCH, "steps": DET_STEPS,
              "ms_per_step": statistics.median(step_ms[2:]), "step_ms": step_ms,
              "images_per_s": DET_BATCH / (statistics.median(step_ms[2:]) * 1e-3),
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "allocated_before_gib": base / 2 ** 30, "wall_s": wall,
              "history": hist, "map50": out["map"], "card": smi}
    print(json.dumps({"train_detector": report}), flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"detector: a loss is not finite: {losses}")
    if any(h["skipped"] for h in hist) or not all(h["fg"] > 0 for h in hist):
        raise AssertionError(f"detector: skipped steps or no foreground: {hist}")
    if not all(x < losses[0] for x in losses[-5:]):
        raise AssertionError(f"detector: the last 5 losses are not below the first: {losses}")
    saved_trained_model(torch, smi, "detector", out, images[0])
    try:
        eval_detector_table(smi, tmp, out)
    finally:
        pool_dir.cleanup()

    model, params = out["model"], out["params"]
    det_cfg = yl.YOLOLossConfig(num_classes=len(TRAIN_CLASSES), img_size=640)
    tx = yt.make_yolo_optimizer(DET_LR, warmup_steps=DET_WARMUP, total_steps=DET_STEPS)
    gt = [t.cuda() for t in yt.targets_from_boxes(boxes[:DET_BATCH], max_gt=96)]
    x = torch.from_numpy(images[:DET_BATCH]).cuda().float() / 255.0
    split = step_split(torch, model, params, tx, out["opt_state"],
                       lambda heads: yl.yolo_detection_loss(heads, *gt, det_cfg)[0], x)
    print(json.dumps({"train_detector_split": {**split, "card": smi}}), flush=True)

    # (3) the detector's step, card against CPU, batch 2, float32, TF32 off
    gb, gc, gv = yt.targets_from_boxes(boxes[:2], max_gt=96)
    x = torch.from_numpy(images[:2]).float() / 255.0
    cpu_model = type(model)(num_classes=len(TRAIN_CLASSES), scale="s", reg_max=16)
    cpu_params = {n: p.cpu() for n, p in params.items()}
    side = {}
    for dev, m, p in (("cuda", model, params), ("cpu", cpu_model, cpu_params)):
        t0 = time.perf_counter()
        xs, gbs, gcs, gvs = (t.to(dev) for t in (x, gb, gc, gv))
        metrics, grads = yt.yolo_loss_and_grads(m, p, xs, gbs, gcs, gvs, det_cfg)
        with torch.no_grad():
            heads = torch.func.functional_call(m, p, (xs,))
            _d, logits, pboxes, anchors, _s = yl.decode_heads(heads, det_cfg)
            scores = torch.sigmoid(logits)
            fg, assigned, _t = yl.task_aligned_assign(scores, pboxes, anchors, gbs, gcs, gvs,
                                                      det_cfg)
        side[dev] = dict(loss=float(metrics["loss"]), grads=grads, fg=fg.cpu(),
                         assigned=assigned.cpu(), scores=scores.cpu(), boxes=pboxes.cpu(),
                         seconds=time.perf_counter() - t0)
    card, cpu = side["cuda"], side["cpu"]
    worst = _worst_leaf(card["grads"], cpu["grads"])
    diff = (card["fg"] != cpu["fg"]) | (card["assigned"] != cpu["assigned"])
    differing = []
    for b, a in diff.nonzero().tolist()[:8]:
        # the anchor's alignment with its CPU-assigned gt on each side
        g = int(cpu["assigned"][b, a])
        cls = int(gc[b, g])
        align = {}
        for name, sd in side.items():
            iou = yl.iou_matrix_xyxy(gb[b:b + 1, g:g + 1], sd["boxes"][b:b + 1, a:a + 1])
            align[name] = float(sd["scores"][b, a, cls] ** 0.5 * iou.clamp(min=0) ** 6.0)
        differing.append({"image": b, "anchor": a, "fg": [bool(card["fg"][b, a]),
                                                           bool(cpu["fg"][b, a])],
                          "assigned": [int(card["assigned"][b, a]), int(cpu["assigned"][b, a])],
                          "align": align})
    row = {"loss": [card["loss"], cpu["loss"]],
           "loss_tol": TRAINER_LOSS_RTOL * max(1.0, abs(cpu["loss"])),
           "fg": int(cpu["fg"].sum()), "assignment_differences": int(diff.sum()),
           "differing": differing, "leaves": len(cpu["grads"]), "worst_leaf": worst[2],
           "max_abs_err": worst[0], "max_abs_cpu": worst[1],
           "tol": TRAIN_RTOL * max(1.0, worst[1]), "cpu_seconds": cpu["seconds"], "card": smi}
    print(json.dumps({"train_detector_card_vs_cpu": row}), flush=True)
    if abs(card["loss"] - cpu["loss"]) > row["loss_tol"] or diff.any():
        raise AssertionError(f"detector step: loss or assignment differ card vs CPU: {row}")
    if not all(bool(torch.isfinite(g).all()) for g in card["grads"].values()) \
            or worst[0] > TRAIN_RTOL * max(1.0, worst[1]):
        raise AssertionError(f"detector step: card gradients differ from the CPU's: {worst}")
    del out, model, params, side, card, cpu
    torch.cuda.empty_cache()

    # (4) the reader from random weights
    t0 = time.perf_counter()
    data = rt.generate_reader_dataset(READER_CIRCUITS, seed0=50_000)
    data_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = rt.train_reader(data, steps=READER_STEPS, batch=READER_BATCH, lr=READER_LR,
                          log_every=1, device="cuda",
                          report=lambda line: print("   " + line, flush=True))
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    step_ms = [1e3 * (b["seconds"] - a["seconds"]) for a, b in zip(hist, hist[1:])]
    t0 = time.perf_counter()
    product = rt.evaluate_product(out["params"], READER_VAL, seed0=990_000, device="cuda")
    eval_s = time.perf_counter() - t0
    losses = [h["loss"] for h in hist]
    print(json.dumps({"train_reader": {
        "name": "reader ReaderConfig() f32 from scratch", "crops": int(len(data["crops"])),
        "dataset_s": data_s, "batch": READER_BATCH, "steps": READER_STEPS,
        "ms_per_step": statistics.median(step_ms[2:]), "step_ms": step_ms,
        "crops_per_s": READER_BATCH / (statistics.median(step_ms[2:]) * 1e-3),
        "peak_memory_gib": peak / 2 ** 30, "allocated_before_gib": base / 2 ** 30,
        "history": hist, "evaluate_product": product, "evaluate_s": eval_s,
        "card": smi}}), flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"reader: a loss is not finite: {losses}")
    saved_trained_model(torch, smi, "reader", out)

    model = out["model"]
    dev_batch = [torch.from_numpy(np.ascontiguousarray(data[k][:READER_BATCH])).cuda()
                 for k in ("crops", "cls", "val", "dir", "val_w")]

    split = step_split(torch, model, out["params"], rt.make_reader_optimizer(READER_LR,
                                                                             READER_STEPS),
                       out["opt_state"], lambda heads: rt.heads_loss(heads, *dev_batch[1:])[0],
                       dev_batch[0])
    print(json.dumps({"train_reader_split": {**split, "card": smi}}), flush=True)

    # (5) the reader's step, card against CPU, on the first 64 crops
    cpu_model = type(model)(ReaderConfig())
    sel = slice(0, 64)
    batch = [torch.from_numpy(np.ascontiguousarray(data[k][sel]))
             for k in ("crops", "cls", "val", "dir", "val_w")]
    side = {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        p = {n: t.to(dev) for n, t in out["params"].items()}
        metrics, grads = rt.reader_loss_and_grads(m, p, *(t.to(dev) for t in batch))
        side[dev] = (float(metrics["loss"]), grads)
    worst = _worst_leaf(side["cuda"][1], side["cpu"][1])
    row = {"loss": [side["cuda"][0], side["cpu"][0]], "leaves": len(side["cpu"][1]),
           "worst_leaf": worst[2], "max_abs_err": worst[0], "max_abs_cpu": worst[1],
           "tol": TRAIN_RTOL * max(1.0, worst[1]), "card": smi}
    print(json.dumps({"train_reader_card_vs_cpu": row}), flush=True)
    if abs(side["cuda"][0] - side["cpu"][0]) > TRAINER_LOSS_RTOL * max(1.0, abs(side["cpu"][0])) \
            or worst[0] > TRAIN_RTOL * max(1.0, worst[1]):
        raise AssertionError(f"reader step: card differs from the CPU: {row}")
    counts = read()
    if any(counts.values()):
        raise AssertionError(f"the trainers launched kernels: {counts}")
    del out, model, side
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from circuitvision_tpu_torch.core import draw
    from circuitvision_tpu_torch.io import image_io
    from circuitvision_tpu_torch.ops.cuda.build import build_all
    from circuitvision_tpu_torch.topology import contours

    t0 = phase("environment")
    print(f"   torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"   card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    done(t0, "environment")

    t0 = phase("build")
    build_all()
    contours.load_library()
    image_io.load_native()
    draw.load_library()
    done(t0, "build (nvcc for every kernel; g++ for the contour tracer, the PNG and JPEG "
             "decoders and the drawing rasteriser)")
    floor = launch_floor(smi)

    t0 = phase("kernels at t@512")
    summary = {"t@512": run_kernels(torch, "t@512")}
    done(t0, "kernels at t@512")

    t0 = phase("main path at t@512")
    launches = {"t@512": run_main_path(torch)}
    done(t0, "main path at t@512")

    t0 = phase("kernels and window routes at L@1024")
    summary["l@1024"] = run_kernels(torch, "l@1024")
    run_routes(torch)
    done(t0, "kernels and window routes at L@1024")

    t0 = phase("main path at L@1024")
    launches["l@1024"] = run_l_path(torch)
    done(t0, "main path at L@1024")

    t0 = phase("the reference deployment from the reference's checkpoints: YOLOv11-l@640 + "
               "SAM2.1-L@1024, LoRA folded")
    launches["reference"] = run_reference_deployment(torch, smi)
    done(t0, "the reference deployment")

    t0 = phase("batched path at s@640 + t@512 (analyze_many, fused morphology)")
    launches["batch"], raster_shapes = run_batched_path(torch, smi)
    done(t0, "batched path")

    t0 = phase("kernel at the batched path's raster shapes")
    summary["batch"] = run_kernels(torch, "batch", raster_shapes)
    done(t0, "line-enhancement kernel")

    t0 = phase("trained product at s@640 + t@512 + reader")
    launches["product"], launches["product-batch"], product = run_trained_product(torch, smi)
    done(t0, "trained product")

    t0 = phase("serving, simulation and the CLI on the trained product")
    launches["served"] = run_serving(torch, smi, product)
    done(t0, "serving, simulation and the CLI")

    t0 = phase("image input and the web UI on the trained product; the FLOP count")
    launches["web"] = run_web_ui(torch, smi, product)
    del product
    run_flops(torch, smi)
    done(t0, "image input, the web UI and the FLOP count")

    t0 = phase("the black-box VLM value pass on the trained product: Gemini and OpenRouter "
               "against a stub, the enumeration image, the eval script")
    launches["vlm"] = run_value_pass(torch, smi)
    done(t0, "the black-box VLM value pass")

    t0 = phase("off-preset head widths: bf16 Hiera at head widths 64, 60 and 136")
    for name, config, seed in (("off-preset", OFF_PRESET, 3), ("off-preset-60", OFF_PRESET_60, 4),
                               ("off-preset-136", OFF_PRESET_136, 6)):
        run_off_preset(torch, smi, name, config, seed)
    run_width60_kernels(torch, smi)
    done(t0, "off-preset head widths")

    t0 = phase("trunk LayerNorm option at the L@1024 widths")
    launches["trunk-ln"] = run_trunk_ln_path(torch)
    summary["trunk-ln"] = run_kernels(torch, "trunk-ln")
    done(t0, "trunk LayerNorm option")

    t0 = phase("fine-tune kernels: FlashAttention's lse forward and backward at L@1024, t@1024")
    summary["train"] = run_kernels(torch, "train")
    summary["train-t"] = run_kernels(torch, "train-t")
    done(t0, "fine-tune kernels")

    t0 = phase("fine-tune: L_CUT card vs CPU gradients, SAM2.1-L@1024 paths A and B, "
               "t@1024, path C")
    launches["train"], launches["train-t"] = run_training(torch, smi)
    done(t0, "fine-tune")

    t0 = phase("training the detector and the reader: pool, YOLOv11-s@640, reader")
    run_trainers(torch, smi)
    done(t0, "training the detector and the reader")

    def entry(name, s, counts):
        return {"launches": counts[name], "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                "eager_ms": s["eager_ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": "bytes" if s["t_bytes"] >= s["t_ops"] else "operations",
                "library_ms": s["library_ms"],
                **({"library_note": s["library_note"]} if s["library_note"] else {})}

    print(json.dumps({"kernels_t512": [{"name": n, **entry(n, s, launches["t@512"])}
                                       for n, s in summary["t@512"].items()]}))
    # the float32 instances at t@512, the trained product's (its SAM2 is
    # float32): device ms summed over its launches per analyze()
    print(json.dumps({"kernels_t512_f32": [
        {"name": n, "launches": launches["product"][n], **s["f32"]}
        for n, s in summary["t@512"].items() if "f32" in s]}))
    print(json.dumps({"kernels_train_t1024": [
        {"name": n, "route": "cuda", "source": SOURCES[n], "replaces": REPLACES[n],
         "path": "train-t", **entry(n, s, launches["train-t"])}
        for n, s in summary["train-t"].items()]}))
    # one entry per kernel, on the path that runs it: the seven Hiera and
    # head kernels on L@1024, the line enhancement on the batched path,
    # the LayerNorms on the trunk LayerNorm option, FlashAttention's three
    # on the whole-tree fine-tune (launches per step at batch 1)
    kernels = [{"name": n, "route": "cuda", "source": SOURCES[n], "replaces": REPLACES[n],
                "path": path, **entry(n, s, launches[path]),
                "launches_t512": launches["t@512"][n],
                "launches_reference": launches["reference"][n],
                "launches_trained_product": launches["product"][n],
                "launches_trained_product_batch": launches["product-batch"][n],
                "launches_served": launches["served"][n],
                "launches_web_ui": launches["web"][n],
                "launches_vlm": launches["vlm"][n]}
               for path in ("l@1024", "batch", "trunk-ln", "train")
               for n, s in summary[path].items()]
    print(json.dumps({"launch_floor": floor}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
