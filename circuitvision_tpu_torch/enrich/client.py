"""VLM client protocol, and the client the environment names.

Counterpart of the JAX package's `enrich/client.py:24-40` and the
`reader:` branch of its `default_client` (:267-277). The port runs
box-driven clients only: the pipeline hands them the id'd boxes and the
direction crops (`get_labels_batch_boxes`, `get_directions_batch`). The
HTTP clients (Gemini, OpenRouter) with their reply parsers, the fake
whole-image client, the PaliGemma head and `prompts.py` are not ported
yet (ROADMAP Queue A 6, 12). Where JAX logs a failed `reader:` load and
carries on without a client, the port raises — the same deliberate
difference it keeps for SAM2.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Protocol, Sequence

import numpy as np

from ..core.types import BBox

logger = logging.getLogger(__name__)


class VLMClient(Protocol):
    """The reads the pipeline asks of a client."""

    def get_labels_batch_boxes(self, enum_images: Sequence[np.ndarray],
                               enum_boxes_lists: Sequence[Sequence[BBox]]) -> list[list[dict]]:
        """Stage-2 extraction: per image, one {'id','class','value'} row
        per box with a visual id."""
        ...

    def get_directions_batch(self, crops: Sequence[np.ndarray],
                             classes: Sequence[str]) -> list[tuple[str, str]]:
        """Per-component polarity: (direction, reason) per crop, each one
        of UP/DOWN/LEFT/RIGHT/UNKNOWN and SIGN/ARROW/UNKNOWN."""
        ...


def default_client(device="cuda") -> Optional[VLMClient]:
    """The client CIRCUITVISION_VLM names, or None when it names none.

    `reader:<orbax dir>` loads the trained crop reader
    (enrich/trained_reader.py) on `device`; a failed load raises. A
    `paligemma:` spec raises NotImplementedError: that head is not ported.
    The HTTP clients' keys (GEMINI_API_KEY, OPENROUTER_API_KEY), which
    the JAX package reads here, name clients the port does not have; they
    are ignored, with a warning."""
    spec = os.getenv("CIRCUITVISION_VLM", "")
    if spec.startswith("reader:"):
        from .trained_reader import load_trained_reader

        return load_trained_reader(spec.split(":", 1)[1], device=device)
    if spec.startswith("paligemma:"):
        raise NotImplementedError(f"CIRCUITVISION_VLM={spec}: the PaliGemma head is not "
                                  f"ported (ROADMAP Queue A 12)")
    for key in ("GEMINI_API_KEY", "OPENROUTER_API_KEY"):
        if os.getenv(key):
            logger.warning("%s is set, but the HTTP VLM clients are not ported (ROADMAP "
                           "Queue A 6); running without a client", key)
    return None
