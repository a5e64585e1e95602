"""The optax pieces the detector and reader trainers use, over dicts of
tensors, with optax's formulas, order of operations and state.

A transform is `Transform(init, update)`: `init(params)` gives its state,
`update(updates, state, params)` gives (new updates, new state), as an
optax GradientTransformation does; trees are {name: tensor} dicts. The
states mirror optax's, leaf for leaf:

  * `scale_by_adam`: {"count" int32, "mu", "nu"} (optax ScaleByAdamState);
  * `add_decayed_weights` and `clip_by_global_norm`: {} (EmptyState);
  * `scale_by_learning_rate` with a schedule: {"count" int32}
    (ScaleByScheduleState), with a constant: {};
  * `chain`: a tuple of its members' states;
  * `apply_if_finite`: {"notfinite_count" int32, "last_finite" bool,
    "total_notfinite" int32, "inner_state"} (ApplyIfFiniteState).

Counters, schedules and bias corrections are tensors on the parameters'
device, so a step makes no host round trip: `apply_if_finite` computes
the inner update and selects it or the rejection (zero updates, the old
state) with `torch.where`, where optax branches with `lax.cond` — the
same values. Schedules take the int32 count tensor and return a float32
tensor.
"""
from __future__ import annotations

import math
from typing import Callable, Mapping, NamedTuple, Sequence

import torch

Tree = Mapping[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


class Transform(NamedTuple):
    init: Callable
    update: Callable


def _device(tree: Tree) -> torch.device:
    return next(iter(tree.values())).device if tree else torch.device("cpu")


def _int0(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _inc(count: torch.Tensor) -> torch.Tensor:
    """optax numerics.safe_increment for int32: stops at the largest int32."""
    return torch.where(count < torch.iinfo(torch.int32).max, count + 1, count)


# -------------------------------------------------------------- schedules
def constant_schedule(value: float) -> Schedule:
    return lambda count: torch.full((), value, dtype=torch.float32, device=count.device)


def linear_schedule(init_value: float, end_value: float, transition_steps: int,
                    transition_begin: int = 0) -> Schedule:
    """optax.linear_schedule (polynomial_schedule with power 1)."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count - max(transition_begin, 0), 0, transition_steps)
        frac = 1 - c.to(torch.float32) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if decay_steps <= 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps}.")

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count.to(torch.float32), max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / float(decay_steps)))
        return init_value * ((1 - alpha) * cosine + alpha)
    return schedule


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: schedules[i + 1] from boundaries[i] on, its
    count restarted there."""
    def schedule(count: torch.Tensor) -> torch.Tensor:
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, out, s(count - boundary))
        return out
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule (exponent 1)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)],
        [warmup_steps])


# ------------------------------------------------------------- transforms
def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)
    return Transform(init, update)


def global_norm(tree: Tree) -> torch.Tensor:
    """optax.global_norm: √(Σ over leaves of Σ x²)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in tree.values()))


def clip_by_global_norm(max_norm: float) -> Transform:
    def update(updates, state, params=None):
        norm = global_norm(updates)
        keep = norm < max_norm
        return {n: torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
                for n, g in updates.items()}, state
    return Transform(lambda params: {}, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> Transform:
    def init(params):
        return {"count": _int0(_device(params)),
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(updates, state, params=None):
        mu = {n: (1 - b1) * g + b1 * state["mu"][n] for n, g in updates.items()}
        nu = {n: (1 - b2) * (g * g) + b2 * state["nu"][n] for n, g in updates.items()}
        count = _inc(state["count"])
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=c.device), c)
        out = {}
        for n in updates:
            mu_hat = mu[n] / bc1.to(mu[n].dtype)
            nu_hat = nu[n] / bc2.to(nu[n].dtype)
            out[n] = mu_hat / (torch.sqrt(nu_hat + eps_root) + eps)
        return out, {"count": count, "mu": mu, "nu": nu}
    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the parameters")
        return {n: g + weight_decay * params[n] for n, g in updates.items()}, state
    return Transform(lambda params: {}, update)


def scale_by_learning_rate(learning_rate: float | Schedule) -> Transform:
    """optax.scale_by_learning_rate (sign flipped): a constant, or a
    schedule counted in its own state."""
    if callable(learning_rate):
        def init(params):
            return {"count": _int0(_device(params))}

        def update(updates, state, params=None):
            step = -learning_rate(state["count"])
            return ({n: step.to(g.dtype) * g for n, g in updates.items()},
                    {"count": _inc(state["count"])})
        return Transform(init, update)
    return Transform(lambda params: {},
                     lambda updates, state, params=None:
                     ({n: -learning_rate * g for n, g in updates.items()}, state))


def adamw(learning_rate: float | Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0, weight_decay: float = 1e-4) -> Transform:
    """optax.adamw: Adam, then the decoupled decay over every leaf, then
    the learning rate."""
    return chain(scale_by_adam(b1, b2, eps, eps_root), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def _select(keep: torch.Tensor, a, b):
    """`a` where `keep`, else `b`, leaf for leaf over matching trees."""
    if isinstance(a, Mapping):
        return {k: _select(keep, a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        return tuple(_select(keep, x, y) for x, y in zip(a, b))
    return torch.where(keep, a, b)


def apply_if_finite(inner: Transform, max_consecutive_errors: int) -> Transform:
    """optax.apply_if_finite: an update whose gradients hold a NaN or an
    infinity is dropped (zero updates, the inner state kept) unless more
    than `max_consecutive_errors` in a row have been."""
    def init(params):
        dev = _device(params)
        return {"notfinite_count": _int0(dev),
                "last_finite": torch.ones((), dtype=torch.bool, device=dev),
                "total_notfinite": _int0(dev),
                "inner_state": inner.init(params)}

    def update(updates, state, params=None):
        finite = torch.stack([torch.isfinite(g).all() for g in updates.values()]).all()
        notfinite = torch.where(finite, torch.zeros_like(state["notfinite_count"]),
                                _inc(state["notfinite_count"]))
        apply = finite | (notfinite > max_consecutive_errors)
        new_updates, new_inner = inner.update(updates, state["inner_state"], params)
        zeros = {n: torch.zeros_like(g) for n, g in new_updates.items()}
        return _select(apply, new_updates, zeros), {
            "notfinite_count": notfinite,
            "last_finite": finite,
            "total_notfinite": torch.where(finite, state["total_notfinite"],
                                           _inc(state["total_notfinite"])),
            "inner_state": _select(apply, new_inner, state["inner_state"]),
        }
    return Transform(init, update)


def apply_updates(params: Tree, updates: Tree) -> dict[str, torch.Tensor]:
    """optax.apply_updates: p + u in p's dtype; leaves without an update
    (frozen ones) are the same tensors."""
    return {n: (p + updates[n]).to(p.dtype) if n in updates else p for n, p in params.items()}
