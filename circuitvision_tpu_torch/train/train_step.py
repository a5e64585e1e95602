"""SAM2 fine-tune step — the JAX package's `train/train_step.py` in PyTorch.

The reference fine-tunes SAM2 with PEFT/LoRA in torch (offline, not in
its app; footprint at src/circuit_analyzer.py:203-223). The step here
trains, as the JAX package's does, either

  * the trainable surface (`TRAINABLE_PATTERNS`, the reference's LoRA
    target modules plus the wrapper's net-new parameters) — selective:
    only those leaves require grad, so the frozen trunk prefix builds no
    graph, stores no activations and keeps the forward kernels
    (hiera.force_fused with an int cutoff); or
  * the whole tree (`selective=False`, e.g. with an all-True mask):
    every block and the refinement head on the module path
    (hiera.force_fused(False)), the global blocks' attention through
    FlashAttention, the one kernel with a backward.

Parameters are a dict {port name: tensor} (`dict(model.named_parameters())`
detached), run through the model with torch.func.functional_call, as the
JAX step applies its variable tree. The optimizer (`Optimizer`) is Adam
written out with optax's formulas and order of operations — the moments
kept in each parameter's dtype, eps outside the square root, bias
correction in float32 cast to the moment's dtype — hard-frozen off the
mask (no update, no moment buffers: the multi_transform + set_to_zero the
JAX package uses, never optax.masked, which would pass frozen gradients
through as updates), with optax.MultiSteps' gradient accumulation and
optax's schedules (counted in updates). `multichip=True` is the JAX flag:
the module path and einsum attention everywhere. The data- and
model-parallel step over torch.distributed ranks is `train/distributed.py`,
which wraps this step and keeps its kernels (a rank runs them on whole
tensors).
"""
from __future__ import annotations

import math
import re
from typing import Callable, Mapping

import torch

from ..core.config import TrainConfig
from ..models.bridge import flax_names
from ..ops.cuda.build import KernelError
from .losses import combined_loss
from .optim import apply_updates

#: flax param-path regexes matching the reference LoRA target surface
#: (src/circuit_analyzer.py:156-199) plus the wrapper's own parameters;
#: matched against each port parameter's flax path (bridge.flax_names)
TRAINABLE_PATTERNS = (
    r"dense_embedding1",
    r"dense_embedding2",
    r"sparse_embedding",
    r"refinement_layer/",
    r"sam_mask_decoder/transformer/layers_\d+/(self_attn|cross_attn_token_to_image|cross_attn_image_to_token)/(q_proj|k_proj|v_proj|out_proj)/",
    r"sam_mask_decoder/transformer/layers_\d+/(mlp_lin1|mlp_lin2)/",
    r"sam_mask_decoder/iou_prediction_head/layers_2/",
    r"conv_s0/",
    r"conv_s1/",
    r"neck/convs_[23]_conv/",
    r"trunk/blocks_4[47]/(attn/qkv|mlp_layers_0|proj)/",
)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def trainable_mask(model: torch.nn.Module, patterns=TRAINABLE_PATTERNS) -> dict[str, bool]:
    """{port parameter name: True where the parameter is fine-tuned}, by
    the patterns over its flax path."""
    compiled = [re.compile(p) for p in patterns]
    return {name: any(c.search(path) for c in compiled)
            for name, path in flax_names(model).items()}


# ------------------------------------------------------------- schedules
def learning_rate_schedule(cfg: TrainConfig) -> float | Callable[[int], torch.Tensor]:
    """The configured LR: a constant (reference-parity default), a
    linear-warmup constant, or warmup→cosine decay, as optax computes them
    (float32): a float, or a function of the update count."""
    lr = cfg.learning_rate
    if cfg.schedule == "cosine":
        if cfg.total_steps <= 0:
            raise ValueError("schedule='cosine' requires total_steps > 0")
        end = lr * cfg.min_lr_ratio
        alpha = 0.0 if lr == 0.0 else end / lr
        decay_steps = cfg.total_steps - cfg.warmup_steps
        if decay_steps <= 0:
            raise ValueError("The cosine_decay_schedule requires positive decay_steps, got "
                             f"decay_steps={decay_steps}.")

        def cosine(count: int) -> torch.Tensor:
            if count < cfg.warmup_steps:
                return _linear(0.0, lr, cfg.warmup_steps, count)
            c = torch.tensor(float(min(count - cfg.warmup_steps, decay_steps)),
                             dtype=torch.float32)
            cos = 0.5 * (1 + torch.cos(torch.tensor(math.pi, dtype=torch.float32) * c
                                       / decay_steps))
            return lr * ((1 - alpha) * cos + alpha)
        return cosine
    if cfg.schedule != "constant":
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    if cfg.warmup_steps > 0:
        def warmup(count: int) -> torch.Tensor:
            if count < cfg.warmup_steps:
                return _linear(0.0, lr, cfg.warmup_steps, count)
            return torch.tensor(lr, dtype=torch.float32)
        return warmup
    return lr


def _linear(init: float, end: float, steps: int, count: int) -> torch.Tensor:
    """optax.linear_schedule at `count`, in float32."""
    if steps <= 0:
        return torch.tensor(init, dtype=torch.float32)
    frac = 1 - torch.tensor(min(max(count, 0), steps), dtype=torch.float32) / steps
    return (init - end) * frac + end


# ------------------------------------------------------------- optimizer
class Optimizer:
    """Adam with optax's formulas over a dict of parameters, with the
    leaves off `trainable` hard-frozen and optax.MultiSteps' accumulation
    when cfg.grad_accum_steps > 1.

    State (`init`): "count" (int32, updates made), "mu" and "nu" (one
    buffer per trainable leaf, in its dtype), "schedule_count" where the
    LR is a schedule, and with accumulation "mini_step", "gradient_step"
    and "acc_grads" (the running mean of the micro-steps' gradients).
    `update` returns (updates of the trainable leaves, new state): zero
    updates between flushes, the Adam step of the mean at each k-th."""

    def __init__(self, cfg: TrainConfig, trainable: Mapping[str, bool] | None = None):
        self.cfg = cfg
        self.trainable = None if trainable is None else {n for n, t in trainable.items() if t}
        self.lr = learning_rate_schedule(cfg)
        self.k = cfg.grad_accum_steps

    def _train(self, tree: Mapping) -> list[str]:
        return [n for n in tree if self.trainable is None or n in self.trainable]

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        names = self._train(params)
        zero = lambda: torch.tensor(0, dtype=torch.int32)  # noqa: E731
        state = {"count": zero(), "mu": {n: torch.zeros_like(params[n]) for n in names},
                 "nu": {n: torch.zeros_like(params[n]) for n in names}}
        if callable(self.lr):
            state["schedule_count"] = zero()
        if self.k > 1:
            state.update(mini_step=zero(), gradient_step=zero(),
                         acc_grads={n: torch.zeros_like(params[n]) for n in names})
        return state

    def _adam(self, grads: Mapping[str, torch.Tensor], state: dict) -> tuple[dict, dict]:
        count = state["count"] + 1
        new = {"count": count, "mu": {}, "nu": {}}
        bc1 = 1 - torch.tensor(ADAM_B1, dtype=torch.float32) ** count.float()
        bc2 = 1 - torch.tensor(ADAM_B2, dtype=torch.float32) ** count.float()
        if callable(self.lr):
            step = -self.lr(int(state["schedule_count"]))
            new["schedule_count"] = state["schedule_count"] + 1
        updates = {}
        for n, g in grads.items():
            mu = (1 - ADAM_B1) * g + ADAM_B1 * state["mu"][n]
            nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state["nu"][n]
            mu_hat = mu / bc1.to(mu.dtype).to(mu.device)
            nu_hat = nu / bc2.to(nu.dtype).to(nu.device)
            u = mu_hat / (torch.sqrt(nu_hat + 0.0) + ADAM_EPS)
            if callable(self.lr):
                u = step.to(u.dtype).to(u.device) * u
            else:
                u = u * -self.lr
            new["mu"][n], new["nu"][n], updates[n] = mu, nu, u
        return updates, new

    def update(self, grads: Mapping[str, torch.Tensor], state: dict) -> tuple[dict, dict]:
        grads = {n: grads[n] for n in self._train(grads)}
        if self.k == 1:
            return self._adam(grads, state)
        mini = int(state["mini_step"])
        acc = {n: a + (grads[n] - a) / (mini + 1) for n, a in state["acc_grads"].items()}
        emit = mini == self.k - 1
        new = {"mini_step": torch.tensor((mini + 1) % self.k, dtype=torch.int32)}
        if emit:
            updates, inner = self._adam(acc, state)
            new.update(inner, gradient_step=state["gradient_step"] + 1,
                       acc_grads={n: torch.zeros_like(a) for n, a in acc.items()})
            return updates, new
        inner = {k: state[k] for k in ("count", "mu", "nu", "schedule_count") if k in state}
        new.update(inner, gradient_step=state["gradient_step"], acc_grads=acc)
        return {n: torch.zeros_like(a) for n, a in acc.items()}, new


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig | None = None,
                   mask: Mapping[str, bool] | None = None) -> tuple[Optimizer, dict[str, bool]]:
    """(Adam on the trainable surface, hard-frozen elsewhere; the mask).
    `mask` overrides the reference LoRA-parity surface (e.g. all-True for
    a full fine-tune)."""
    cfg = cfg or TrainConfig()
    if mask is None:
        mask = trainable_mask(model)
    return Optimizer(cfg, mask), dict(mask)


# ------------------------------------------------------------------- EMA
def init_ema(params: Mapping[str, torch.Tensor], mask: Mapping[str, bool]) -> dict:
    """EMA shadow of the TRAINABLE leaves only (frozen leaves never move)."""
    return {n: p.detach().clone() for n, p in params.items() if mask[n]}


def update_ema(ema: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               decay: float) -> dict:
    """One EMA step over the trainable leaves: e ← d·e + (1−d)·p. Call after
    each optimizer UPDATE (with accumulation, after each flush)."""
    return {n: decay * e + (1.0 - decay) * params[n] for n, e in ema.items()}


def ema_params(params: Mapping[str, torch.Tensor], ema: Mapping[str, torch.Tensor]) -> dict:
    """Eval-weights dict: trainable leaves from the EMA shadow, frozen
    leaves from the live dict (identical by construction)."""
    return {n: ema.get(n, p) for n, p in params.items()}


def _trunk_diff_cutoff(mask: Mapping[str, bool]) -> int:
    """First trunk block the backward pass must reach: min(trainable trunk
    block index), or a sentinel past the deepest block when no trunk
    parameter trains (the whole trunk then keeps its kernels)."""
    cutoff = 1 << 30
    for name, m in mask.items():
        hit = re.match(r"trunk\.blocks_(\d+)\.", name) if m else None
        if hit:
            cutoff = min(cutoff, int(hit.group(1)))
    return cutoff


# ------------------------------------------------------------------ step
def model_loss(model: torch.nn.Module, params: Mapping[str, torch.Tensor], images: torch.Tensor,
               masks: torch.Tensor, cfg: TrainConfig):
    """(loss, metrics) of the segmenter under `params`: high-res logits
    through combined_loss."""
    high, _low, iou_pred = torch.func.functional_call(model, dict(params), (images,))
    return combined_loss(high[..., 0], iou_pred, masks, cfg)


def loss_and_grads(model, params: Mapping[str, torch.Tensor], images, masks,
                   cfg: TrainConfig | None = None, mask: Mapping[str, bool] | None = None,
                   selective: bool = True, multichip: bool = False):
    """(loss, metrics, grads) with grads for every leaf of `params`.

    Whole-tree (selective=False): every leaf requires grad, every kernel
    site on the module path. Selective: only the leaves of `mask` (default
    trainable_mask) require grad; trunk blocks before the earliest
    trainable one keep their kernels and build no graph; frozen leaves get
    zero gradients, as in the JAX package. `multichip`: the module path
    and einsum attention everywhere (make_train_step)."""
    import contextlib

    from ..models.sam2 import hiera

    cfg = cfg or TrainConfig()
    if selective:
        mask = trainable_mask(model) if mask is None else mask
        train = [n for n in params if mask[n]]
        cutoff = False if multichip else _trunk_diff_cutoff(mask)
    else:
        train, cutoff = list(params), False
    leaves = {n: p.detach().requires_grad_(n in train) for n, p in params.items()}
    flash = hiera.force_flash(False) if multichip else contextlib.nullcontext()
    with hiera.force_fused(cutoff), flash:
        loss, metrics = model_loss(model, leaves, images, masks, cfg)
        got = torch.autograd.grad(loss, [leaves[n] for n in train], allow_unused=True)
    grads = dict(zip(train, got))
    grads = {n: grads[n] if grads.get(n) is not None else torch.zeros_like(p)
             for n, p in params.items()}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def check_flash_widths(model: torch.nn.Module, start: int) -> None:
    """Refuse, before any step, a model on the card whose differentiated
    trunk blocks (from `start` on) would hand FlashAttention heads its
    kernels do not take (hiera.flash_blocks, flash_attn.grad_head_width_ok):
    those of a dtype other than float32 and bfloat16. Every head the
    module path gives FlashAttention is at most MAX_HEAD_DIM wide, and the
    kernels take every such width in both dtypes (a bfloat16 head off a
    multiple of 8 zero-padded to the next). On the CPU the plain versions
    take every width and dtype."""
    from ..models.sam2 import hiera
    from ..ops.cuda.flash_attn import grad_head_width_ok

    weight = model.trunk.patch_embed_proj.weight
    if not weight.is_cuda:
        return
    for _i, _tokens, hd in hiera.flash_blocks(model.trunk, model.cfg.resolution, start):
        if not grad_head_width_ok(hd, weight.dtype):
            raise KernelError(f"training on the card: FlashAttention's kernels take float32 "
                              f"and bfloat16 heads; this model's global blocks give it heads "
                              f"of width {hd} in {weight.dtype}")


def make_train_step(model: torch.nn.Module, tx: Optimizer, cfg: TrainConfig | None = None,
                    mask: Mapping[str, bool] | None = None, selective: bool = True,
                    multichip: bool = False):
    """Returns train_step(params, opt_state, images, masks) → (params,
    opt_state, metrics): loss_and_grads, then tx.update and apply_updates.
    `mask` must match the optimizer's (make_optimizer returns it);
    selective=False differentiates the whole tree. A model on the card
    whose differentiated blocks FlashAttention's kernels cannot take
    raises KernelError here (`check_flash_widths`).

    multichip=True is the JAX package's flag: the module path (no fused
    kernel) and einsum attention (no flash) for the whole forward. Under
    JAX's multi-device jit with FSDP-sharded parameters, Mosaic custom
    calls cannot be partitioned by XLA's SPMD pass ("Mosaic kernels cannot
    be automatically partitioned"), while the module path partitions like
    any XLA program. The port's distributed step (train/distributed.py)
    does not need it: each rank gathers its leaves whole and runs the
    kernels on whole tensors."""
    cfg = cfg or TrainConfig()
    if not multichip:
        check_flash_widths(model, _trunk_diff_cutoff(trainable_mask(model) if mask is None
                                                     else mask) if selective else 0)

    def train_step(params, opt_state, images, masks):
        _loss, metrics, grads = loss_and_grads(model, params, images, masks, cfg, mask,
                                               selective, multichip)
        updates, opt_state = tx.update(grads, opt_state)
        return apply_updates(params, updates), opt_state, metrics

    return train_step
