"""PaliGemma VLM head, the JAX package's `models/paligemma` in torch.

SigLIP-So400m vision tower + Gemma-2B decoder with a static KV cache and
a greedy decode loop (`model.py`), weight-only int8 for the decode path
(`quant.py`), an HF-checkpoint converter (`convert.py`), and a
VLMClient-protocol value reader (`reader.py`) that slots into the
pipeline in place of the external Gemini stage-2 call
(`CIRCUITVISION_VLM=paligemma:<dir>[:int8]`, enrich/client.default_client).
The exports are the JAX package's.
"""
from .config import GemmaTextConfig, PaliGemmaConfig, SiglipVisionConfig, tiny_config
from .convert import convert_hf_state, torch_state_to_numpy
from .model import GenerateResult, PaliGemma, greedy_generate
from .quant import quantize_variables
from .reader import ByteTokenizer, PaliGemmaValueReader

__all__ = [
    "ByteTokenizer",
    "GemmaTextConfig",
    "GenerateResult",
    "PaliGemma",
    "PaliGemmaConfig",
    "PaliGemmaValueReader",
    "SiglipVisionConfig",
    "convert_hf_state",
    "greedy_generate",
    "quantize_variables",
    "tiny_config",
    "torch_state_to_numpy",
]
