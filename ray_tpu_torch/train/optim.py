"""Optimizers as plain tensor code: counterpart of the JAX package's
``train/optim.py`` and of the pieces of its optimizer library that it and
``train/step.py`` use (clipping, Adam, weight decay, schedules).

A transformation is an ``(init, update)`` pair over a list of tensors in
a fixed order (the module's parameters), as a ``GradientTransformation``
there is over a pytree: ``init(params) -> state`` and
``update(updates, state, params) -> (updates, state)``. The learning-rate
schedule is read at the count *before* it increments, as the reference
does, so a warmup that starts at 0 gives a zero step first.

``scale_by_adam`` and ``adam`` (the on-device PPO's optimizer) keep their
count on the device and update their moments in place, so a CUDA graph
that holds the state's addresses runs them on replay.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Sequence, Union

import torch

Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    init: Callable[[Sequence[torch.Tensor]], Any]
    update: Callable[..., Any]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32)
                        for t in tensors]).square().sum().sqrt()


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scales all updates by max_norm / norm when the norm reaches
    max_norm (no host sync: the choice is a ``torch.where``)."""

    def update(updates, state, params=None):
        g = global_norm(updates)
        keep = g < max_norm
        return [torch.where(keep, t, t / g.to(t.dtype) * max_norm)
                for t in updates], state

    return GradientTransformation(lambda params: (), update)


def scale_by_adam_lowmem(b1: float = 0.9, b2: float = 0.999,
                         eps: float = 1e-8,
                         state_dtype: Optional[torch.dtype] = torch.bfloat16
                         ) -> GradientTransformation:
    """Adam moments stored in ``state_dtype`` (None: the parameter's own
    dtype, as the reference's ``scale_by_adam``), update math in fp32."""

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=state_dtype or p.dtype)
        return {"count": 0, "mu": [zeros(p) for p in params],
                "nu": [zeros(p) for p in params]}

    def update(updates, state, params=None):
        count = state["count"] + 1
        c1 = 1.0 - b1 ** count
        c2 = 1.0 - b2 ** count
        out, mus, nus = [], [], []
        for g, m, v in zip(updates, state["mu"], state["nu"]):
            g = g.float()
            m32 = b1 * m.float() + (1.0 - b1) * g
            v32 = b2 * v.float() + (1.0 - b2) * g.square()
            out.append((m32 / c1) / (torch.sqrt(v32 / c2) + eps))
            mus.append(m32.to(m.dtype))
            nus.append(v32.to(v.dtype))
        return out, {"count": count, "mu": mus, "nu": nus}

    return GradientTransformation(init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    """The reference's ``scale_by_adam``: moments in the parameters' dtype,
    bias-corrected with the count incremented first; ``eps`` outside the
    square root, ``eps_root`` inside. The count is an int32 tensor on the
    parameters' device, and the count and moments are updated in place."""

    def init(params):
        zeros = [torch.zeros_like(p) for p in params]
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=params[0].device),
                "mu": zeros, "nu": [torch.zeros_like(p) for p in params]}

    def update(updates, state, params=None):
        count = state["count"].add_(1)
        c1 = 1 - torch.pow(b1, count)
        c2 = 1 - torch.pow(b2, count)
        out = []
        for g, m, v in zip(updates, state["mu"], state["nu"]):
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * g ** 2 + b2 * v)
            out.append((m / c1.to(m.dtype))
                       / (torch.sqrt(v / c2.to(v.dtype) + eps_root) + eps))
        return out, state

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """Decoupled weight decay on every leaf (the reference's
    ``add_decayed_weights`` with no mask)."""

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs params")
        return [u + weight_decay * p for u, p in zip(updates, params)], state

    return GradientTransformation(lambda params: (), update)


def scale_by_learning_rate(learning_rate: Union[float, Schedule]
                           ) -> GradientTransformation:
    """Multiplies by -lr; a schedule is read at the count before the
    increment (the reference's ``scale_by_schedule``)."""

    def init(params):
        return {"count": 0}

    def update(updates, state, params=None):
        count = state["count"]
        lr = learning_rate(count) if callable(learning_rate) else learning_rate
        return [-lr * u for u in updates], {"count": count + 1}

    return GradientTransformation(init, update)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return init_value
        c = min(max(count, 0), transition_steps)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, "
                         f"got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """Linear warmup to ``peak_value``, then cosine decay to ``end_value``
    at ``decay_steps`` (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha, exponent)
    return lambda count: (warm(count) if count < warmup_steps
                          else decay(count - warmup_steps))


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> GradientTransformation:
    """The reference's ``adamw``: moments in the parameters' dtype."""
    return chain(scale_by_adam_lowmem(b1, b2, eps, state_dtype=None),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> GradientTransformation:
    """The reference's ``adam`` at a constant rate (a schedule reads a host
    count, which a CUDA graph's replays would not advance)."""
    if callable(learning_rate):
        raise TypeError("adam takes a constant learning rate")
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 scale_by_learning_rate(learning_rate))


def adamw_lowmem(learning_rate, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: Optional[float] = 1.0,
                 state_dtype: torch.dtype = torch.bfloat16
                 ) -> GradientTransformation:
    """AdamW with low-precision moment state: clip, Adam, decay, lr."""
    parts = [clip_by_global_norm(grad_clip)] if grad_clip is not None else []
    parts += [scale_by_adam_lowmem(b1, b2, eps, state_dtype),
              add_decayed_weights(weight_decay),
              scale_by_learning_rate(learning_rate)]
    return chain(*parts)


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup: int = 100, total_steps: int = 10_000,
                      grad_clip: float = 1.0) -> GradientTransformation:
    schedule = warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(total_steps, warmup + 1), end_value=lr * 0.1)
    return chain(clip_by_global_norm(grad_clip),
                 adamw(schedule, b1=0.9, b2=0.95, weight_decay=weight_decay))
