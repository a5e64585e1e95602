"""VLM clients: the protocol, the reply parsers, a fake, the two HTTP
clients, and the client the environment names.

Counterpart of the JAX package's `enrich/client.py`. A client reads the
values of an image's components (stage 2) and the polarity of each
source and diode (stage [4]) in one of two ways:

  * whole images and single crops, as the black-box VLMs do:
    `get_labels(enum_image)` on the image with the ids drawn
    (topology/enumerate_components.py) and `get_direction(crop, cls)`
    per crop, which enrich/directions.py runs on a thread pool;
  * box-driven, as the trained crop reader does: `get_labels_batch_boxes`
    with the id'd boxes and `get_directions_batch` over a chunk's crops.

`GeminiVLMClient` and `OpenRouterVLMClient` speak to the services over
the standard library (urllib.request), sending the JSON that the JAX
clients' SDKs send (google-genai 1.62.0's generateContent, the openai
SDK's chat/completions), with images as base64 PNG
(io/image_io.encode_png); each takes its endpoint, the SDK's public URL
by default. Their error ladders are the JAX ones: a failed direction
read, or a class with no direction, gives UNKNOWN; a failed labels read
raises to the analyzer, which keeps the valueless netlist. Where the JAX
package logs a failed `reader:` or `paligemma:` load and carries on
without a client, the port raises — the same deliberate difference it
keeps for SAM2.
"""
from __future__ import annotations

import ast
import base64
import dataclasses
import functools
import json
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional, Protocol, Sequence

import numpy as np

from ..core import taxonomy
from ..io.image_io import encode_png
from .prompts import DIODE_DIRECTION_PROMPT, LABELS_PROMPT, VOLTAGE_DIRECTION_PROMPT

GEMINI_ENDPOINT = "https://generativelanguage.googleapis.com/"
OPENROUTER_ENDPOINT = "https://openrouter.ai/api/v1"
_UNKNOWN = ("UNKNOWN", "UNKNOWN")


class VLMClient(Protocol):
    """Vision-language model interface used by the pipeline. The batch
    hooks — `get_labels_batch(enum_images)`,
    `get_labels_batch_boxes(enum_images, enum_boxes_lists)` and
    `get_directions_batch(crops, classes)` — are optional; the pipeline
    uses them where a client has them."""

    def get_labels(self, enum_image_rgb: np.ndarray) -> list[dict]:
        """Stage-2 extraction: enumerated image → [{'id','class','value'}]."""
        ...

    def get_direction(self, crop_rgb: np.ndarray, component_class: str) -> tuple[str, str]:
        """Per-component polarity: crop → (direction, reason), each one of
        UP/DOWN/LEFT/RIGHT/UNKNOWN and SIGN/ARROW/UNKNOWN."""
        ...


def parse_vlm_list(text: str) -> list[dict]:
    """Fence-stripping + dual ast/json parser (src/utils.py:249-282).

    str.strip takes a CHARACTER SET, so these strips eat any mix of the
    fence characters at both ends — including, in the second strip, a
    literal backslash: the reference source reads strip('```json\\\\n')
    (backslash + n, not a newline)."""
    formatted = text.strip("```python\n")
    formatted = formatted.strip("```json\\n")
    formatted = formatted.strip("```")
    try:
        return ast.literal_eval(formatted.replace("null", "None"))
    except (SyntaxError, ValueError) as e_ast:
        try:
            return json.loads(formatted)
        except json.JSONDecodeError as e_json:
            raise ValueError(
                f"Failed to parse VLM response. ast error: {e_ast}, json error: "
                f"{e_json}. Formatted response: {formatted}"
            )


def parse_gemini_labels(text: str) -> list[dict]:
    """The direct-Gemini path's parse (gemini_labels, src/utils.py:160-180):
    json first with a null→None ast fallback, and a real newline in the
    json strip set — the OpenRouter path above parses ast first and its
    second strip carries a literal backslash (line 251 against 162)."""
    formatted = text.strip("```python\n")
    formatted = formatted.strip("```json\n")
    formatted = formatted.strip("```")
    try:
        return json.loads(formatted)
    except json.JSONDecodeError:
        try:
            return ast.literal_eval(formatted.replace("null", "None"))
        except Exception as e2:
            raise ValueError(
                f"Failed to parse Gemini response: {e2}. "
                f"Original response: {formatted}"
            )


class FakeVLMClient:
    """Deterministic offline client for tests and air-gapped runs.

    labels: canned stage-2 output (list of dicts) or None → empty list.
    directions: {component_class: (direction, reason)} with a default.
    """

    def __init__(self, labels: Optional[Sequence[dict]] = None,
                 directions: Optional[dict] = None,
                 default_direction: tuple[str, str] = _UNKNOWN):
        self.labels = list(labels) if labels else []
        self.directions = dict(directions or {})
        self.default_direction = default_direction
        self.label_calls = 0
        self.label_batch_calls = 0
        self.direction_calls: list[str] = []

    def get_labels(self, enum_image_rgb: np.ndarray) -> list[dict]:
        self.label_calls += 1
        return list(self.labels)

    def get_labels_batch(self, enum_images_rgb) -> list[Optional[list[dict]]]:
        """Batched stage 2: the canned rows for every image."""
        self.label_batch_calls += 1
        return [list(self.labels) for _ in enum_images_rgb]

    def get_direction(self, crop_rgb: np.ndarray, component_class: str):
        self.direction_calls.append(component_class)
        return self.directions.get(component_class, self.default_direction)


class VLMRequestError(RuntimeError):
    """A VLM service answered with an HTTP error status."""


def _png_b64(image: np.ndarray, encode=base64.b64encode) -> str:
    return encode(encode_png(image)).decode("ascii")


def _inline_png(image: np.ndarray) -> dict:
    """A generateContent image part: PNG in URL-safe base64, as
    google-genai sends bytes."""
    return {"inlineData": {"data": _png_b64(image, base64.urlsafe_b64encode),
                           "mimeType": "image/png"}}


@functools.lru_cache(maxsize=2)
def _opener(loopback: bool) -> urllib.request.OpenerDirector:
    """urllib's opener, built once (its TLS context loads the system's CA
    certificates); a loopback endpoint's without the environment's
    proxies."""
    return urllib.request.build_opener(*([urllib.request.ProxyHandler({})] if loopback else []))


def _post_json(url: str, body: dict, headers: dict) -> dict:
    """POST `body` as JSON and return the JSON reply; an HTTP error status
    raises VLMRequestError."""
    req = urllib.request.Request(url, data=json.dumps(body).encode("utf-8"), method="POST",
                                 headers={"Content-Type": "application/json", **headers})
    loopback = urllib.parse.urlsplit(url).hostname in ("127.0.0.1", "localhost", "::1")
    try:
        with _opener(loopback).open(req) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        detail = exc.read().decode("utf-8", "replace")
        raise VLMRequestError(f"{exc.code} {exc.reason}. {detail}") from None


def _gemini_text(reply: dict) -> Optional[str]:
    """What google-genai's `response.text` gives: the first candidate's
    text parts joined, thought parts left out; None without candidates,
    parts or any text part."""
    candidates = reply.get("candidates") or []
    parts = (candidates[0].get("content") or {}).get("parts") if candidates else None
    if not parts:
        return None
    texts = [p["text"] for p in parts
             if isinstance(p.get("text"), str) and p.get("thought") is not True]
    return "".join(texts) if texts else None


class GeminiVLMClient:
    """Direct Gemini API client (reference gemini_labels path,
    src/utils.py:125-182, and direction path
    src/circuit_analyzer.py:2103-2143). Requires GEMINI_API_KEY."""

    def __init__(self, api_key: Optional[str] = None,
                 labels_model: str = "gemini-2.5-pro-exp-03-25",
                 direction_model: str = "gemini-2.5-flash-lite-preview-06-17",
                 temperature: float = 0.1, top_p: float = 0.98, max_output_tokens: int = 1024,
                 endpoint: str = GEMINI_ENDPOINT):
        self.api_key = api_key or os.getenv("GEMINI_API_KEY")
        if not self.api_key:
            raise ValueError("GEMINI_API_KEY not set")
        self.labels_model = labels_model
        self.direction_model = direction_model
        # Direction-call generation params (reference defaults,
        # src/circuit_analyzer.py:2112-2121); the labels call keeps the
        # reference's fixed temperature 0 (src/utils.py:158).
        self.temperature = temperature
        self.top_p = top_p
        self.max_output_tokens = max_output_tokens
        self.endpoint = endpoint

    def _generate(self, model: str, parts: list, generation_config: dict) -> Optional[str]:
        """One generateContent call as google-genai sends it; the reply's
        text."""
        url = f"{self.endpoint.rstrip('/')}/v1beta/models/{model}:generateContent"
        body = {"contents": [{"parts": parts, "role": "user"}],
                "generationConfig": generation_config}
        return _gemini_text(_post_json(url, body, {"x-goog-api-key": self.api_key}))

    def get_labels(self, enum_image_rgb: np.ndarray) -> list[dict]:
        text = self._generate(
            self.labels_model,
            [_inline_png(enum_image_rgb), {"text": "\n"}, {"text": LABELS_PROMPT}],
            {"temperature": 0.0})
        return parse_gemini_labels(text)

    def get_direction(self, crop_rgb: np.ndarray, component_class: str):
        if component_class in taxonomy.VOLTAGE_CLASSES:
            prompt = VOLTAGE_DIRECTION_PROMPT
        elif component_class in taxonomy.DIODE_CLASSES:
            prompt = DIODE_DIRECTION_PROMPT
        else:
            return _UNKNOWN
        try:
            text = self._generate(self.direction_model, [{"text": prompt}, _inline_png(crop_rgb)],
                                  {"temperature": float(self.temperature),
                                   "topP": float(self.top_p),
                                   "maxOutputTokens": int(self.max_output_tokens),
                                   "responseMimeType": "application/json"})
            parsed = json.loads(text)
            direction = parsed.get("direction")
            reason = parsed.get("reason")
            if direction:
                return str(direction).upper(), str(reason).upper() if reason else "UNKNOWN"
            return _UNKNOWN
        except Exception:
            return _UNKNOWN


class OpenRouterVLMClient:
    """OpenRouter labels client over its OpenAI-style chat/completions —
    the reference's production stage-2 path (src/utils.py:184-285)."""

    def __init__(self, api_key: Optional[str] = None,
                 model: str = "google/gemini-2.5-flash-preview",
                 endpoint: str = OPENROUTER_ENDPOINT):
        self.api_key = api_key or os.getenv("OPENROUTER_API_KEY")
        if not self.api_key:
            raise ValueError("OPENROUTER_API_KEY not set")
        self.model = model
        self.endpoint = endpoint

    def get_labels(self, enum_image_rgb: np.ndarray) -> list[dict]:
        b64 = _png_b64(enum_image_rgb)
        body = {"messages": [{"role": "user", "content": [
                    {"type": "text", "text": LABELS_PROMPT},
                    {"type": "image_url", "image_url": {"url": f"data:image/png;base64,{b64}"}},
                ]}],
                "model": self.model, "temperature": 0}
        reply = _post_json(f"{self.endpoint.rstrip('/')}/chat/completions", body,
                           {"Authorization": f"Bearer {self.api_key}"})
        if not reply.get("choices"):
            raise ValueError("VLM response contained no choices")
        return parse_vlm_list(reply["choices"][0]["message"]["content"])

    def get_direction(self, crop_rgb: np.ndarray, component_class: str):
        return _UNKNOWN  # direction uses the Gemini client


def default_client(enrich=None, device="cuda") -> Optional[VLMClient]:
    """Pick a client from the environment; None when none is named (the
    pipeline then degrades as the reference does without
    GEMINI_API_KEY, src/circuit_analyzer.py:133-147).

    CIRCUITVISION_VLM=reader:<orbax dir> loads the trained crop reader
    (enrich/trained_reader.py) on `device`; a failed load raises.
    CIRCUITVISION_VLM=paligemma:<orbax dir> loads the PaliGemma head
    (models/paligemma, at PaliGemmaConfig()) on `device`, weights converted
    by `python -m circuitvision_tpu_torch.models.checkpoint
    convert-paligemma`; a trailing ':int8' (paligemma:<dir>:int8)
    quantizes the decode path weight-only at load, on the device
    (models/paligemma/quant.py); a failed load raises. Otherwise GEMINI_API_KEY gives GeminiVLMClient and
    OPENROUTER_API_KEY OpenRouterVLMClient, built from `enrich`
    (core.config.EnrichConfig: the direction model and generation
    parameters, the OpenRouter model; None keeps the reference
    defaults)."""
    spec = os.getenv("CIRCUITVISION_VLM", "")
    if spec.startswith("reader:"):
        from .trained_reader import load_trained_reader

        return load_trained_reader(spec.split(":", 1)[1], device=device)
    if spec.startswith("paligemma:"):
        from ..core.config import resolve_device
        from ..models import paligemma
        from ..models.checkpoint import load_variables
        from ..models.paligemma.quant import quantize_variables_on_device

        rest = spec.split(":", 1)[1]
        quant = rest.endswith(":int8")
        ckpt = rest[: -len(":int8")] if quant else rest
        device = resolve_device(device, "default_client")
        cfg = paligemma.PaliGemmaConfig()
        variables = load_variables(ckpt)
        if quant:
            cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, quant_int8=True))
            variables = quantize_variables_on_device(variables, device)
        return paligemma.PaliGemmaValueReader(cfg=cfg, variables=variables, device=device)
    if os.getenv("GEMINI_API_KEY"):
        if enrich is not None:
            return GeminiVLMClient(direction_model=enrich.direction_model,
                                   temperature=enrich.temperature, top_p=enrich.top_p,
                                   max_output_tokens=enrich.max_output_tokens)
        return GeminiVLMClient()
    if os.getenv("OPENROUTER_API_KEY"):
        if enrich is not None:
            return OpenRouterVLMClient(model=enrich.labels_model)
        return OpenRouterVLMClient()
    return None
