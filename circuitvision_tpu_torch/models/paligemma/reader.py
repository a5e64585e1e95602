"""VLM value reader: PaliGemma behind the pipeline's VLMClient protocol —
the JAX package's `models/paligemma/reader.py` in torch.

The reader keeps the reference's interface contract: get_labels takes
the enumerated RGB image and yields the `[{'id','class','value'}]`
records the external VLM returns (parsed with the same parse_vlm_list as
the HTTP clients); get_direction takes a component crop and yields
(direction, reason). The batched hooks (`get_labels_batch`,
`get_directions_batch`) are what the pipeline calls per chunk.

Tokenizer: PaliGemma's SentencePiece model is not in the repository. The
reader accepts any (encode, decode) pair; `ByteTokenizer` is a
self-contained fallback that runs the whole path end to end (with random
weights it reads noise — the tests hold the machinery: prompt layout,
image-token prefix, greedy loop, parsing).

Preprocessing (resize to image_size², scale to [-1, 1]) runs on the
reader's device; generation is one `greedy_generate` call per batch,
padded to a power-of-two bucket.
"""
from __future__ import annotations

import dataclasses
import logging
import re
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ...core.config import resolve_device
from ...enrich.client import parse_vlm_list
from ...ops.image import resize_bilinear
from .config import PaliGemmaConfig
from .model import from_variables, greedy_generate, variables_of

logger = logging.getLogger(__name__)


class ByteTokenizer:
    """UTF-8 byte fallback tokenizer.

    ids 0..255 = bytes shifted into the tail of the vocab is NOT done —
    instead bytes map to ids [base, base+256) so the special ids
    (pad/eos/bos/image) keep their PaliGemma positions. Requires
    vocab_size >= base + 256."""

    def __init__(self, cfg: PaliGemmaConfig, base: int = 16):
        if cfg.text.vocab_size < base + 256:
            raise ValueError("vocab too small for the byte tokenizer")
        reserved = {cfg.pad_token_id, cfg.eos_token_id, cfg.bos_token_id,
                    cfg.image_token_id}
        if any(base <= r < base + 256 for r in reserved):
            raise ValueError("byte range collides with special ids")
        self.base = base

    def encode(self, text: str) -> list[int]:
        return [self.base + b for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(
            i - self.base for i in ids if self.base <= i < self.base + 256
        )
        return data.decode("utf-8", errors="replace")


def siglip_rescale(x: torch.Tensor) -> torch.Tensor:
    # SigLIP normalization: uint8 [0,255] → [-1, 1] (mean/std 0.5).
    return x / 127.5 - 1.0


def preprocess_images(images: Sequence[np.ndarray], image_size: int,
                      device="cuda") -> torch.Tensor:
    """RGB uint8 arrays (any sizes) → (B, S, S, 3) float32 in [-1, 1] on
    `device`: the antialiased bilinear resize (`ops.image.resize_bilinear`,
    jax.image's triangle filter), applied only when the size differs."""
    device = resolve_device(device, "preprocess_images")
    out = []
    for img in images:
        x = torch.as_tensor(np.ascontiguousarray(img), device=device).to(torch.float32)
        if tuple(x.shape[:2]) != (image_size, image_size):
            x = resize_bilinear(x, (image_size, image_size), antialias=True)
        out.append(siglip_rescale(x))
    return torch.stack(out)


# The stage-2 ask, condensed to PaliGemma's short-instruction style (the
# verbatim reference prompt in enrich/prompts.py targets a chat model;
# PaliGemma-class models are steered with short task prefixes).
LABELS_TASK = "extract component id, class, value as JSON list"
DIRECTION_TASK = "which direction does the component point; answer UP, DOWN, LEFT or RIGHT and SIGN or ARROW"


@dataclasses.dataclass
class PaliGemmaValueReader:
    """VLMClient implementation backed by PaliGemma on `device`, built
    from `variables` (the JAX package's tree, numpy or tensors) at
    `dtype`. Once built, `variables` is the model's own tree (views of
    its weights), so the reader keeps one copy of them."""

    cfg: PaliGemmaConfig
    variables: dict
    encode_fn: Optional[Callable[[str], list[int]]] = None
    decode_fn: Optional[Callable[[Sequence[int]], str]] = None
    max_new_tokens: int = 256
    # Direction answers are two words ("RIGHT ARROW") — ~3 SentencePiece
    # or ~11 byte-fallback tokens. A per-task budget keeps the decode
    # loop and the KV cache (t_max = prompt + budget) sized to the
    # answer instead of the stage-2 JSON budget.
    direction_max_new_tokens: int = 16
    dtype: torch.dtype = torch.float32
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device, "PaliGemmaValueReader")
        self.model = from_variables(self.cfg, self.variables, self.dtype, self.device)
        self.variables = variables_of(self.model)
        if self.encode_fn is None or self.decode_fn is None:
            bt = ByteTokenizer(self.cfg)
            self.encode_fn = self.encode_fn or bt.encode
            self.decode_fn = self.decode_fn or bt.decode

    def build_prompt_ids(self, task: str) -> list[int]:
        """Canonical PaliGemma layout: [image]*N + BOS + task + \\n."""
        c = self.cfg
        return (
            [c.image_token_id] * c.num_image_tokens
            + [c.bos_token_id]
            + list(self.encode_fn(task))
            + list(self.encode_fn("\n"))
        )

    def generate(self, images: Sequence[np.ndarray], task: str,
                 max_new_tokens: Optional[int] = None) -> list[str]:
        """Batched greedy decode; one greedy_generate call for the batch.

        The batch is padded up to a power-of-two bucket (zero pixels after
        the rescale, rows_valid=False — padded rows emit pad tokens and are
        sliced off), as the JAX reader pads to reuse its compiled
        programs; the EOS is dropped before decoding."""
        c = self.cfg
        b = len(images)
        bucket = 1
        while bucket < b:
            bucket *= 2
        pixels = preprocess_images(images, c.vision.image_size, self.device)
        if bucket > b:
            pad = torch.zeros((bucket - b,) + tuple(pixels.shape[1:]), dtype=pixels.dtype,
                              device=pixels.device)
            pixels = torch.cat([pixels, pad], dim=0)
        ids = self.build_prompt_ids(task)
        input_ids = torch.tensor([ids] * bucket, dtype=torch.int64, device=self.device)
        valid = torch.tensor([True] * b + [False] * (bucket - b), device=self.device)
        res = greedy_generate(
            self.model, input_ids, pixels, valid,
            max_new_tokens if max_new_tokens is not None else self.max_new_tokens,
        )
        toks = res.tokens[:b].cpu().numpy()
        lens = res.lengths[:b].cpu().numpy()
        texts = []
        for row, n in zip(toks, lens):
            seq = [int(t) for t in row[:n] if t != c.eos_token_id]
            texts.append(self.decode_fn(seq))
        return texts

    # ---- VLMClient protocol ----

    def get_labels(self, enum_image_rgb: np.ndarray) -> list[dict]:
        text = self.generate([enum_image_rgb], LABELS_TASK)[0]
        return parse_vlm_list(text)

    def get_labels_batch(self, enum_images_rgb: Sequence[np.ndarray]
                         ) -> list[Optional[list[dict]]]:
        """Batched stage 2: one generate call for the whole batch, with
        per-image failure isolation: an unparseable row yields None (the
        caller keeps that image's valueless netlist)."""
        texts = self.generate(list(enum_images_rgb), LABELS_TASK)
        out: list[Optional[list[dict]]] = []
        for i, text in enumerate(texts):
            try:
                out.append(parse_vlm_list(text))
            except Exception as e:
                logger.warning("stage-2 parse failed for image %d: %s", i, e)
                out.append(None)
        return out

    @staticmethod
    def _parse_direction(text: str) -> tuple[str, str]:
        text = text.upper()
        # first whole-word occurrence IN TEXT ORDER ("supply points DOWN"
        # must not match the UP inside SUPPLY)
        dm = re.search(r"\b(UP|DOWN|LEFT|RIGHT)\b", text)
        rm = re.search(r"\b(SIGN|ARROW)\b", text)
        return (dm.group(1) if dm else "UNKNOWN",
                rm.group(1) if rm else "UNKNOWN")

    def get_direction(self, crop_rgb: np.ndarray, component_class: str) -> tuple[str, str]:
        text = self.generate([crop_rgb], DIRECTION_TASK,
                             max_new_tokens=self.direction_max_new_tokens)[0]
        return self._parse_direction(text)

    def get_directions_batch(self, crops_rgb: Sequence[np.ndarray],
                             component_classes: Sequence[str]) -> list[tuple[str, str]]:
        """All eligible component crops in one generate call (the direction
        prompt is class-independent, so the crops batch cleanly); a crop
        whose answer names no direction reads UNKNOWN."""
        texts = self.generate(list(crops_rgb), DIRECTION_TASK,
                              max_new_tokens=self.direction_max_new_tokens)
        return [self._parse_direction(t) for t in texts]
