"""PaliGemma: SigLIP tower + projector + Gemma decoder, with a greedy
decode loop: the JAX package's `models/paligemma/model.py` in torch.

Composition and numerics are the JAX package's (which follows the HF
reference, transformers/models/paligemma/modeling_paligemma.py):
  - vision features → linear projector → divided by sqrt(text hidden)
    in the features' dtype;
  - substituted for the image placeholder tokens in the UNSCALED token
    embeddings, gated on the placeholder id over the first N positions;
    the whole sequence is scaled by sqrt(hidden) inside the decoder;
  - position ids are 1-indexed (cache position + 1);
  - prefill attends bidirectionally over the valid input tokens, future
    cache slots masked; a decode step attends to the prefill slots the
    original mask allows and to every generated slot up to its own;
  - the LM head is tied to the token embedding.

The JAX package runs the whole greedy generation as one jitted
`lax.while_loop`; here it is a Python loop over device tensors
(`greedy_generate`) whose stop test reads the previous step's flag
through pinned memory, so the host queues the next step while the card
runs the current one.

The port's modules carry the JAX tree's names. `state_dict_from_variables`
takes the JAX package's variable tree (numpy, float or int8) to this
model's state dict: a Dense `kernel` (in, out) becomes `weight` (out, in),
a conv kernel HWIO becomes OIHW, a flax LayerNorm `scale` becomes
`weight`, and the int8 `kernel_q` is stored (out, in) like the float
weight (`gemma.QuantDense`); `embedding_q`, `scale` and every other leaf
keep their names, int8 and float32 kept. `variables_from_state_dict` is
its exact inverse (what the converter and the orbax writer write).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ...core.config import resolve_device
from ..bridge import flatten, nest
from ..layers import LayerNorm
from .config import PaliGemmaConfig
from .gemma import GemmaDecoder, RMSNorm, make_kv_cache
from .vision import SiglipVisionTower


class Embed(nn.Module):
    """flax `nn.Embed`: a row lookup, and `attend`, the product against
    the transposed table (the tied LM head)."""

    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num_embeddings, features, dtype=dtype))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]

    def attend(self, hidden: torch.Tensor) -> torch.Tensor:
        return hidden @ self.embedding.T


class QuantEmbed(nn.Module):
    """Weight-only int8 tied embedding / LM head (per-row scales).

    The lookup reads one int8 row per token and applies its scale in
    float32; `attend` runs the float path's product, against the
    transposed int8 table cast to the compute dtype, then applies the row
    scales to the logits in float32 — the same contraction form as
    `Embed.attend`, so a power-of-two-scaled checkpoint gives the float
    logits bit for bit."""

    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("embedding_q", torch.zeros(num_embeddings, features,
                                                        dtype=torch.int8))
        self.register_buffer("scale", torch.ones(num_embeddings))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = self.embedding_q[ids].float()
        return (rows * self.scale[ids][..., None]).to(self.dtype)

    def attend(self, hidden: torch.Tensor) -> torch.Tensor:
        logits = hidden @ self.embedding_q.to(self.dtype).T
        return (logits.float() * self.scale).to(self.dtype)


def _bias(valid: torch.Tensor) -> torch.Tensor:
    """Additive float32 mask: 0 where `valid`, finfo(float32).min elsewhere."""
    neg = torch.finfo(torch.float32).min
    return torch.zeros(valid.shape, dtype=torch.float32, device=valid.device) \
        .masked_fill_(~valid, neg)


class PaliGemma(nn.Module):
    def __init__(self, cfg: PaliGemmaConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.projection_dim != cfg.text.hidden_size:
            raise ValueError("projector output must match the text width")
        self.cfg, self.dtype = cfg, dtype
        self.vision_tower = SiglipVisionTower(cfg.vision, dtype)
        self.projector = nn.Linear(cfg.vision.hidden_size, cfg.projection_dim, dtype=dtype)
        embed = QuantEmbed if cfg.text.quant_int8 else Embed
        self.embed_tokens = embed(cfg.text.vocab_size, cfg.text.hidden_size, dtype)
        self.decoder = GemmaDecoder(cfg.text, dtype)
        # sqrt(text hidden) in the features' dtype (exact as a Python float)
        self.feature_scale = float(torch.tensor(cfg.text.hidden_size ** 0.5, dtype=dtype,
                                                device="cpu"))

    @property
    def device(self) -> torch.device:
        return self.projector.weight.device

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        # weight-tied LM head (reference: lm_head.weight == embed_tokens.weight)
        return self.embed_tokens.attend(hidden)

    def image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.projector(self.vision_tower(pixel_values)) / self.feature_scale

    def prefill_hidden(self, input_ids: torch.Tensor, attn_mask: torch.Tensor,
                       k_caches: torch.Tensor, v_caches: torch.Tensor,
                       pixel_values: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`prefill` up to the final norm: hidden (B, S, C); the caches are
        written in place."""
        c = self.cfg
        embeds = self.embed_tokens(input_ids)
        if pixel_values is not None:
            feats = self.image_features(pixel_values).to(embeds.dtype)
            # the canonical layout puts the image tokens first; a caller that
            # puts a real token there keeps its embedding (masked_scatter)
            n = feats.shape[1]
            is_placeholder = (input_ids[:, :n] == c.image_token_id)[..., None]
            head = torch.where(is_placeholder, feats, embeds[:, :n])
            embeds = torch.cat([head, embeds[:, n:]], dim=1)
        b, s = input_ids.shape
        t = k_caches.shape[2]
        # bidirectional over valid input tokens; future cache slots masked
        valid = torch.cat([attn_mask.bool(),
                           torch.zeros((b, t - s), dtype=torch.bool, device=embeds.device)], 1)
        bias = _bias(valid)[:, None, :].expand(b, s, t)
        position_ids = (torch.arange(s, device=embeds.device) + 1)[None].expand(b, s)
        return self.decoder(embeds, bias, position_ids, k_caches, v_caches, 0)

    def prefill(self, input_ids: torch.Tensor, attn_mask: torch.Tensor,
                k_caches: torch.Tensor, v_caches: torch.Tensor,
                pixel_values: Optional[torch.Tensor] = None):
        """input_ids (B, S) with image_token_id placeholders, attn_mask
        (B, S) 1 = real token, the (L, B, T, n_kv, hd) caches, pixel_values
        (B, H, W, 3) or None. Returns (logits (B, S, V), k_caches,
        v_caches)."""
        hidden = self.prefill_hidden(input_ids, attn_mask, k_caches, v_caches, pixel_values)
        return self.logits(hidden), k_caches, v_caches

    def decode_step(self, token: torch.Tensor, pos: int, prefill_mask: torch.Tensor,
                    k_caches: torch.Tensor, v_caches: torch.Tensor):
        """One greedy step: token (B,) at cache slot `pos`; returns
        (logits (B, V), k_caches, v_caches)."""
        b = token.shape[0]
        t = k_caches.shape[2]
        s_pre = prefill_mask.shape[1]
        dev = token.device
        slots = torch.arange(t, device=dev)
        # prefill slots gated by the original mask; generated slots by <= pos
        pre_ok = torch.cat([prefill_mask.bool(),
                            torch.zeros((b, t - s_pre), dtype=torch.bool, device=dev)], 1)
        valid = torch.where(slots[None, :] < s_pre, pre_ok, (slots <= pos)[None, :])
        bias = _bias(valid)[:, None, :]
        position_ids = torch.full((b, 1), pos + 1, dtype=torch.int64, device=dev)
        hidden = self.decoder(self.embed_tokens(token[:, None]), bias, position_ids,
                              k_caches, v_caches, pos)
        return self.logits(hidden[:, 0]), k_caches, v_caches


@dataclasses.dataclass
class GenerateResult:
    tokens: torch.Tensor  # (B, max_new) int32, PAD after EOS
    # emitted tokens incl. the EOS — counted per step, NOT inferred from
    # pad scanning (a model legitimately emitting pad_token_id mid-stream
    # must not truncate the row)
    lengths: torch.Tensor  # (B,) int32


class _StopFlag:
    """A device bool read one step late without stalling the stream: the
    value is copied to pinned memory as soon as it exists and an event
    marks the copy, so `get` waits for that copy, not for the work queued
    after it."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.host = torch.zeros((), dtype=torch.bool, pin_memory=True)
            self.event = torch.cuda.Event()

    def set(self, value: torch.Tensor) -> None:
        if self.cuda:
            self.host.copy_(value, non_blocking=True)
            self.event.record()
        else:
            self.value = bool(value)

    def get(self) -> bool:
        if self.cuda:
            self.event.synchronize()
            return bool(self.host)
        return self.value


@torch.no_grad()
def greedy_generate(model: PaliGemma, input_ids: torch.Tensor, pixel_values: torch.Tensor,
                    rows_valid: torch.Tensor, max_new_tokens: int) -> GenerateResult:
    """Greedy generation: prefill, then up to `max_new_tokens` decode
    steps on `model`'s device.

    Prompts are uniform-length (no padding), so the last prefill logit is
    the first next-token distribution. Rows that are not valid start
    done. Each step emits `where(done, pad, tok)`, counts the rows not
    done, sets done where the token was EOS, then runs a decode step; the
    loop stops when every row is done or after max_new_tokens. argmax
    takes the first maximum, as jnp.argmax does.
    """
    cfg = model.cfg
    dev = model.device
    input_ids = input_ids.to(dev)
    b, s = input_ids.shape
    attn_mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    kc, vc = make_kv_cache(cfg.text, b, s + max_new_tokens, dtype=model.dtype, device=dev)
    hidden = model.prefill_hidden(input_ids, attn_mask, kc, vc, pixel_values.to(dev))
    tok = model.logits(hidden[:, -1]).argmax(-1)
    tokens = torch.full((b, max_new_tokens), cfg.pad_token_id, dtype=torch.int32, device=dev)
    done = ~rows_valid.to(dev)
    count = torch.zeros((b,), dtype=torch.int32, device=dev)
    flag = _StopFlag(dev)
    flag.set(done.all())
    for i in range(max_new_tokens):
        if flag.get():
            break
        tokens[:, i] = torch.where(done, cfg.pad_token_id, tok)
        count += (~done).int()
        done = done | (tok == cfg.eos_token_id)
        flag.set(done.all())
        logits, kc, vc = model.decode_step(tok, s + i, attn_mask, kc, vc)
        tok = logits.argmax(-1)
    return GenerateResult(tokens=tokens, lengths=count)


# ---------------------------------------------------------------- weights
def _swap(arr, axes):
    return arr.permute(*axes) if isinstance(arr, torch.Tensor) else np.transpose(arr, axes)


def port_leaf(path: tuple, arr):
    """One JAX variable at `path` ("params" first) → (state-dict key, the
    leaf in the port's layout); numpy arrays or tensors."""
    mods, name = path[1:-1], path[-1]
    if name in ("kernel", "kernel_q"):
        arr = arr.T if arr.ndim == 2 else _swap(arr, (3, 2, 0, 1))
        name = "weight" if name == "kernel" else name
    elif name == "scale" and mods[0] == "vision_tower":  # flax LayerNorm
        name = "weight"
    return ".".join(mods + (name,)), arr


def jax_leaf(key: str, arr):
    """`port_leaf`'s inverse: a state-dict key and leaf → (JAX path, the
    leaf in the JAX layout)."""
    *mods, name = key.split(".")
    if name == "kernel_q" or (name == "weight" and arr.ndim == 2):
        arr = arr.T
        name = "kernel" if name == "weight" else name
    elif name == "weight" and arr.ndim == 4:
        arr, name = _swap(arr, (2, 3, 1, 0)), "kernel"
    elif name == "weight" and mods[0] == "vision_tower":
        name = "scale"
    return ("params", *mods, name), arr


def state_dict_from_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's PaliGemma variables {"params": ...} (numpy arrays
    or tensors, float or int8) → this model's state dict, dtypes kept."""
    out = {}
    for path, leaf in flatten(variables):
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.from_numpy(np.array(leaf))
        key, arr = port_leaf(path, leaf)
        out[key] = arr
    return out


def variables_of(model: nn.Module) -> dict:
    """The JAX variable tree of `model`'s state, each leaf a tensor view of
    the model's own storage in the JAX layout."""
    return nest(jax_leaf(k, t.detach()) for k, t in model.state_dict().items())


def variables_from_state_dict(state: Mapping[str, torch.Tensor]) -> dict:
    """`state_dict_from_variables`'s inverse: nested dicts of C-order numpy
    arrays, int8 kept and every float leaf float32."""
    def host(t):
        t = t.detach().cpu()
        return np.ascontiguousarray((t if t.dtype == torch.int8 else t.float()).numpy())

    return nest(jax_leaf(k, host(t)) for k, t in state.items())


def from_variables(cfg: PaliGemmaConfig, variables: Mapping, dtype=torch.float32,
                   device="cuda") -> PaliGemma:
    """A PaliGemma on `device` in `dtype` holding `variables` (the JAX tree;
    numpy arrays or tensors). Every name and shape must match
    (load_state_dict(strict=True)); float leaves are cast to each
    parameter's dtype (the norms stay float32), int8 leaves stay int8."""
    device = resolve_device(device, "from_variables")
    with torch.device("meta"):
        model = PaliGemma(cfg, dtype)
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict_from_variables(variables), strict=True)
    return model.eval()


def seeded_model(cfg: PaliGemmaConfig, seed: int, dtype=torch.float32, device="cuda",
                 std: float = 0.02) -> PaliGemma:
    """A float PaliGemma made on `device` from a torch.Generator seeded with
    `seed`: LayerNorm scales 1, RMSNorm weights 0 (flax's inits), every
    other parameter N(0, std²) drawn in `named_parameters` order. Nothing
    is built on the host when `device` is the card."""
    if cfg.text.quant_int8:
        raise ValueError("seeded_model makes float weights; quantize them "
                         "(quant.quantize_variables_on_device) for quant_int8")
    device = resolve_device(device, "seeded_model")
    with torch.device("meta"):
        model = PaliGemma(cfg, dtype)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name, p in model.named_parameters():
            mod, _, leaf = name.rpartition(".")
            if leaf == "weight" and isinstance(modules[mod], LayerNorm):
                p.fill_(1.0)
            elif leaf == "weight" and isinstance(modules[mod], RMSNorm):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=gen)
    return model.eval()


def param_count(model: nn.Module) -> int:
    return sum(t.numel() for t in model.state_dict().values())
