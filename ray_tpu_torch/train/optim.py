"""Optimizers as plain tensor code: counterpart of the JAX package's
``train/optim.py`` and of the pieces of its optimizer library that it and
``train/step.py`` use (clipping, Adam, weight decay, schedules).

A transformation is an ``(init, update)`` pair over a list of tensors in
a fixed order (the module's parameters), as a ``GradientTransformation``
there is over a pytree: ``init(params, groups=None) -> state`` and
``update(updates, state, params) -> (updates, state)``. The learning-rate
schedule is read at the count *before* it increments, as the reference
does, so a warmup that starts at 0 gives a zero step first.

``groups`` (``leaf_groups``) says which tensors are the layers of one JAX
leaf, stacked ``[L, ...]`` there. Element-wise transformations ignore it;
``adafactor``, whose parts reduce over a whole leaf, runs on the leaves.
A Python scalar meets a tensor as JAX's weak typing has it: rounded to
the tensor's dtype first (``_weak``).

``scale_by_adam`` and ``adam`` (the on-device PPO's optimizer) keep their
count on the device and update their moments in place, so a CUDA graph
that holds the state's addresses runs them on replay.
"""

from __future__ import annotations

import math
import re
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    init: Callable[..., Any]
    update: Callable[..., Any]


class Leaf(NamedTuple):
    """One JAX leaf: the indices of its tensors, and whether they are the
    layers of a stacked ``[L, ...]`` leaf (else one tensor as it is)."""
    members: Tuple[int, ...]
    stacked: bool


_BLOCK = re.compile(r"(.*?blocks)\.(\d+)\.(.+)")


def leaf_groups(names: Sequence[str]) -> List[Leaf]:
    """The JAX leaves of a module's parameters, from their names: the
    layers ``<p>blocks.<i>.<name>`` stack into the leaf ``<p>blocks.<name>``
    (in layer order), every other parameter is a leaf of its own. Leaves
    come in the order of their first tensor."""
    leaves: List[Optional[Leaf]] = []
    stacks: Dict[str, Tuple[int, Dict[int, int]]] = {}
    for idx, name in enumerate(names):
        m = _BLOCK.fullmatch(name)
        if m is None:
            leaves.append(Leaf((idx,), False))
            continue
        key = f"{m.group(1)}.{m.group(3)}"
        if key not in stacks:
            stacks[key] = (len(leaves), {})
            leaves.append(None)
        stacks[key][1][int(m.group(2))] = idx
    for key, (pos, layers) in stacks.items():
        if sorted(layers) != list(range(len(layers))):
            raise ValueError(f"{key}: layers {sorted(layers)} are not "
                             f"0..{len(layers) - 1}")
        leaves[pos] = Leaf(tuple(layers[i] for i in range(len(layers))), True)
    return leaves


def _no_state(params, groups=None):
    return ()


def _weak(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a JAX Python scalar meets an array of
    that dtype."""
    return float(torch.tensor(x, dtype=dtype))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32)
                        for t in tensors]).square().sum().sqrt()


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params, groups=None):
        return tuple(t.init(params, groups) for t in transforms)

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

    return GradientTransformation(_no_state, update)


def scale_by_adam_lowmem(b1: float = 0.9, b2: float = 0.999,
                         eps: float = 1e-8,
                         state_dtype: Optional[torch.dtype] = torch.bfloat16
                         ) -> GradientTransformation:
    """Adam moments stored in ``state_dtype`` (None: the parameter's own
    dtype, as the reference's ``scale_by_adam``), update math in fp32."""

    def init(params, groups=None):
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

    def init(params, groups=None):
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

    return GradientTransformation(_no_state, update)


def scale_by_learning_rate(learning_rate: Union[float, Schedule]
                           ) -> GradientTransformation:
    """Multiplies by -lr, rounded to each update's dtype; a schedule is
    read at the count before the increment (the reference's
    ``scale_by_schedule``)."""

    def init(params, groups=None):
        return {"count": 0}

    def update(updates, state, params=None):
        count = state["count"]
        lr = learning_rate(count) if callable(learning_rate) else learning_rate
        by_dtype = {}  # one rounding of -lr per dtype
        out = []
        for u in updates:
            if u.dtype not in by_dtype:
                by_dtype[u.dtype] = _weak(-lr, u.dtype)
            out.append(u * by_dtype[u.dtype])
        return out, {"count": count + 1}

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


# ---------------------------------------------------------------------------
# Adafactor, as optax 0.2.6 builds it (``optax/_src/alias.py:225-327``).
#
# The parts below take one tensor a JAX leaf; ``by_leaf`` stacks the
# module's layers into those leaves and back. In 16-bit leaves the
# roundings fall where the reference's eager ops put them:
#   - ``g * g`` rounds, then ``+ eps`` (eps itself rounded first);
#   - every ``jnp.mean`` accumulates in fp32 and rounds its result
#     (``_mean``);
#   - the decay ``1 - (count + 1)^-0.8`` is an fp32 scalar, so each EMA
#     runs in fp32 and rounds once when stored in the leaf's dtype;
#   - the row/column factors, each ``** -0.5``, and each product and
#     quotient with the update round to the leaf's dtype;
#   - the block RMS of the clip and of the parameter scale round at the
#     square, the mean and the root; -lr rounds as a weak scalar.
# ---------------------------------------------------------------------------

# optax's defaults, the only values its ``adafactor`` is called with here.
DECAY_RATE = 0.8
FACTORED_EPS = 1e-30
MIN_DIM_TO_FACTOR = 128
CLIPPING_THRESHOLD = 1.0
MIN_SCALE = 1e-3

def _mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean``: an fp32 sum for 16-bit ``x``, divided, then rounded
    to ``x``'s dtype."""
    if dim is None:
        return x.mean(dtype=torch.float32).to(x.dtype)
    return x.mean(dim, keepdim=keepdim, dtype=torch.float32).to(x.dtype)


def _factored_dims(shape, min_dim_size_to_factor: int
                   ) -> Optional[Tuple[int, int]]:
    """(second-largest, largest) axis when the second reaches
    ``min_dim_size_to_factor``, ties broken by numpy's argsort as the
    reference breaks them; None for a leaf kept whole."""
    if len(shape) < 2:
        return None
    order = np.argsort(tuple(shape))
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def scale_by_factored_rms() -> GradientTransformation:
    """Scales each leaf by a factored estimate of its gradient RMS: row and
    column EMAs of ``g^2 + eps`` (``v_row``, ``v_col``) for a leaf whose
    two largest axes reach ``MIN_DIM_TO_FACTOR``, a full EMA ``v``
    otherwise; all in the leaf's dtype. Reads ``params`` for shapes and
    dtypes."""

    def init(params, groups=None):
        v_row, v_col, v = [], [], []
        for p in params:
            dims = _factored_dims(p.shape, MIN_DIM_TO_FACTOR)
            if dims is None:
                v_row.append(None)
                v_col.append(None)
                v.append(torch.zeros_like(p))
                continue
            d1, d0 = dims
            shape = list(p.shape)
            v_row.append(p.new_zeros(shape[:d0] + shape[d0 + 1:]))
            v_col.append(p.new_zeros(shape[:d1] + shape[d1 + 1:]))
            v.append(None)
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("scale_by_factored_rms needs params")
        t = torch.tensor(state["count"] + 1, dtype=torch.float32)
        decay = 1.0 - t ** -DECAY_RATE  # fp32, as the reference's
        beta, keep = float(decay), float(1.0 - decay)
        out, rows, cols, vs = [], [], [], []
        for g, p, vr, vc, v in zip(updates, params, state["v_row"],
                                   state["v_col"], state["v"]):
            dtype = p.dtype
            g_sq = g * g + _weak(FACTORED_EPS, g.dtype)
            dims = _factored_dims(p.shape, MIN_DIM_TO_FACTOR)
            if dims is None:
                v = (beta * v.float() + keep * g_sq.float()).to(dtype)
                out.append(g * v ** -0.5)
            else:
                d1, d0 = dims
                vr = (beta * vr.float()
                      + keep * _mean(g_sq, d0).float()).to(dtype)
                vc = (beta * vc.float()
                      + keep * _mean(g_sq, d1).float()).to(dtype)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (vr / _mean(vr, reduced_d1, keepdim=True)) ** -0.5
                col_factor = vc ** -0.5
                out.append(g * row_factor.unsqueeze(d0)
                           * col_factor.unsqueeze(d1))
            rows.append(vr)
            cols.append(vc)
            vs.append(v)
        return out, {"count": state["count"] + 1, "v_row": rows,
                     "v_col": cols, "v": vs}

    return GradientTransformation(init, update)


def clip_by_block_rms() -> GradientTransformation:
    """Divides each leaf by max(1, RMS(leaf) / CLIPPING_THRESHOLD)."""

    def update(updates, state, params=None):
        out = []
        for u in updates:
            rms = _mean(u * u).sqrt()
            out.append(u / (rms / _weak(CLIPPING_THRESHOLD, u.dtype))
                       .clamp_min(1.0))
        return out, state

    return GradientTransformation(_no_state, update)


def scale_by_param_block_rms() -> GradientTransformation:
    """Multiplies each leaf's update by its parameter's RMS, at least
    ``MIN_SCALE``."""

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("scale_by_param_block_rms needs params")
        out = []
        for u, p in zip(updates, params):
            rms = _mean(p * p).sqrt().clamp_min(_weak(MIN_SCALE, p.dtype))
            out.append(u * rms)
        return out, state

    return GradientTransformation(_no_state, update)


def _to_leaves(tensors, groups: Sequence[Leaf]) -> List[torch.Tensor]:
    return [torch.stack([tensors[i] for i in g.members]) if g.stacked
            else tensors[g.members[0]] for g in groups]


def _from_leaves(leaves, groups: Sequence[Leaf], n: int) -> List:
    out = [None] * n
    for leaf, g in zip(leaves, groups):
        parts = leaf.unbind(0) if g.stacked else (leaf,)
        for i, t in zip(g.members, parts):
            out[i] = t
    return out


def by_leaf(inner: GradientTransformation) -> GradientTransformation:
    """Runs ``inner`` on the JAX leaves: the tensors of each group of
    ``init``'s ``groups`` stacked ``[L, ...]`` (each tensor a leaf of its
    own when ``groups`` is None). Its state is kept per leaf, as the
    reference keeps it; the updates come back one tensor a parameter."""

    def init(params, groups=None):
        groups = list(groups or (Leaf((i,), False)
                                 for i in range(len(params))))
        return {"groups": groups,
                "inner": inner.init(_to_leaves(params, groups))}

    def update(updates, state, params=None):
        groups = state["groups"]
        leaf_params = None if params is None else _to_leaves(params, groups)
        out, inner_state = inner.update(_to_leaves(updates, groups),
                                        state["inner"], leaf_params)
        return (_from_leaves(out, groups, len(updates)),
                {"groups": groups, "inner": inner_state})

    return GradientTransformation(init, update)


def adafactor(learning_rate: Union[float, Schedule]
              ) -> GradientTransformation:
    """optax's ``adafactor`` with its defaults (no momentum, no weight
    decay): factored RMS scaling, block-RMS clip, -lr, the parameters'
    block RMS, run on the JAX leaves (``by_leaf``). The reference applies
    lr unsigned and ends with ``scale(-1)``; rounding is symmetric under
    negation, so -lr first gives the same bits with one pass fewer."""
    return by_leaf(chain(
        scale_by_factored_rms(),
        clip_by_block_rms(),
        scale_by_learning_rate(learning_rate),
        scale_by_param_block_rms()))
