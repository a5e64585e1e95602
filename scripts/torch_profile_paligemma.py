"""Time the PaliGemma-3B-pt-224 VLM head of the PyTorch port on the card:
the port of scripts/profile_paligemma.py.

Measures the production shape of the value reader's call
(models/paligemma/reader.py: generate): prefill over [256 image tokens +
BOS + LABELS_TASK + "\\n"] (305 tokens with the byte tokenizer), then
greedy decode steps, through `greedy_generate`. The weights are random,
drawn on the card in bf16 from a seeded torch.Generator (nothing is built
on the host); timing does not depend on them, and argmax over 257k
random logits never meets EOS, so every call decodes all `--new` tokens.

For each batch: one warm-up call, then `--runs` timed calls (host clock
around work that ends in a synchronize) and as many prefills alone; ms per
call, prefill ms, decode ms per step ((call − prefill) / new tokens),
images/s, tokens/s and the peak device memory, with the card's name and
power limit; then a prefill and a call of PROFILED_STEPS new tokens
under torch.profiler: the device's busy ms (the kernels' self device
time summed) of the prefill and of a decode step, the call's busy ms
from those two, and its idle share against the unprofiled median (a
short profiled call: the profiler's own cost grows with every op it
records). `--int8` quantizes the decoder and the tied embedding
weight-only on the card (quant.quantize_variables_on_device) and times
that model too.

Usage: python scripts/torch_profile_paligemma.py [batch ...] [--new N] [--runs R]
           [--int8] [--seed S]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from circuitvision_tpu_torch.models.paligemma import model as pm  # noqa: E402
from circuitvision_tpu_torch.models.paligemma.config import PaliGemmaConfig  # noqa: E402
from circuitvision_tpu_torch.models.paligemma.gemma import make_kv_cache  # noqa: E402
from circuitvision_tpu_torch.models.paligemma.quant import (  # noqa: E402
    quantize_variables_on_device,
)
from circuitvision_tpu_torch.models.paligemma.reader import (  # noqa: E402
    LABELS_TASK, ByteTokenizer,
)


def prompt_ids(cfg: PaliGemmaConfig) -> list[int]:
    tok = ByteTokenizer(cfg)
    return ([cfg.image_token_id] * cfg.num_image_tokens + [cfg.bos_token_id]
            + tok.encode(LABELS_TASK) + tok.encode("\n"))


def quantized(model: pm.PaliGemma) -> pm.PaliGemma:
    """The int8 twin of `model`, quantized on its device; `model`'s float
    decoder is freed as it goes when the caller holds no other reference."""
    cfg, dtype, device = model.cfg, model.dtype, model.device
    tree = pm.variables_of(model)
    del model
    vq = quantize_variables_on_device(tree)
    cfg_q = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, quant_int8=True))
    return pm.from_variables(cfg_q, vq, dtype, device)


#: decode steps of the profiled call
PROFILED_STEPS = 4


def device_ms(fn) -> float:
    """Busy ms of the device over one call of `fn`: torch.profiler's
    self device time of every kernel, summed (0 without a card)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3


def measure(model: pm.PaliGemma, batch: int, new: int, runs: int = 3) -> dict:
    """One warm-up, then `runs` timed generate calls and prefills at
    `batch` (zero pixels, every row valid): medians and the peak memory."""
    cfg, dev = model.cfg, model.device
    ids = torch.tensor([prompt_ids(cfg)] * batch, device=dev)
    pixels = torch.zeros((batch, cfg.vision.image_size, cfg.vision.image_size, 3), device=dev)
    valid = torch.ones((batch,), dtype=torch.bool, device=dev)

    def call():
        return pm.greedy_generate(model, ids, pixels, valid, new)

    def prefill():
        kc, vc = make_kv_cache(cfg.text, batch, ids.shape[1] + new, model.dtype, dev)
        with torch.no_grad():
            hidden = model.prefill_hidden(ids, torch.ones_like(ids), kc, vc, pixels)
            return model.logits(hidden[:, -1]).argmax(-1)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = call()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    call_ms, prefill_ms = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    ms, pre = statistics.median(call_ms), statistics.median(prefill_ms)
    emitted = int(res.lengths.max())
    busy_prefill = device_ms(prefill)
    busy_step = (device_ms(lambda: pm.greedy_generate(model, ids, pixels, valid, PROFILED_STEPS))
                 - busy_prefill) / PROFILED_STEPS
    busy = busy_prefill + emitted * busy_step
    return {"batch": batch, "new_tokens": new, "emitted": emitted, "prompt_tokens": ids.shape[1],
            "ms_per_call": ms, "ms_per_call_runs": call_ms, "prefill_ms": pre,
            "prefill_ms_runs": prefill_ms, "decode_ms_per_step": (ms - pre) / emitted,
            "images_per_s": batch / ms * 1e3, "tokens_per_s": batch * emitted / ms * 1e3,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "device_ms_per_call": busy, "device_prefill_ms": busy_prefill,
            "device_decode_ms_per_step": busy_step,
            "idle_share": 1.0 - busy / ms,
            "first_call_s": first_s, "dtype": str(model.dtype).replace("torch.", ""),
            "int8": model.cfg.text.quant_int8}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batches", nargs="*", type=int, default=[1, 4, 8])
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile_paligemma: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    cfg = PaliGemmaConfig()
    model = pm.seeded_model(cfg, args.seed, torch.bfloat16, "cuda")
    print(json.dumps({"params": pm.param_count(model), "card": card}), flush=True)
    for b in args.batches:
        print(json.dumps({**measure(model, b, args.new, args.runs), "card": card}), flush=True)
    if args.int8:
        model = quantized(model)
        for b in args.batches:
            print(json.dumps({**measure(model, b, args.new, args.runs), "card": card}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
