"""Expert parallelism: a mixture-of-experts FFN with all_to_all dispatch.
Counterpart of the JAX package's ``parallel/moe.py``.

Experts are sharded over the ``ep`` mesh axis; tokens are routed top-k,
dispatched to expert shards with a tiled all_to_all, processed as dense
batched products at a fixed capacity, and combined back weighted by the
router's probabilities. Routing, dispatch and the expert products are
fp32, as in the reference.

Static shapes: capacity = int(capacity_factor * tokens * k / experts),
padded up to a multiple of 8; tokens past an expert's capacity are
dropped, and the router's aux loss pushes toward balance.

``moe_dropless`` is the dropless top-k path beside it, for a rank that
holds a contiguous share of the experts (``experts_held``): it routes over
all of them, sorts the (token, choice) pairs by expert, runs only the held
experts' SwiGLU products over their contiguous row ranges in the weights'
type, and adds their outputs back weighted by the router. Nothing is
dropped and no capacity is set; what the other ranks' experts add is not
computed here (there is no exchange).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..observability import tracing
from .collective import all_to_all, axis_size


def router_topk(logits, k: int):
    """Top-k gating with normalized probs. logits: [tokens, E]."""
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)  # [tokens, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return gate_vals, gate_idx, probs


def load_balance_loss(probs, gate_idx, num_experts: int):
    """Switch-transformer aux loss on the top-1 choice: experts times the
    sum of mean assignment times mean probability."""
    assign = F.one_hot(gate_idx[..., 0], num_experts).float()
    density = assign.mean(0)
    density_proxy = probs.mean(0)
    return num_experts * (density * density_proxy).sum()


def _dispatch_mask(gate_idx, gate_vals, num_experts: int, capacity: int):
    """Dispatch and combine tensors at a fixed capacity.

    The (token, choice) pairs queue token-major (``gate_idx`` flattened
    row by row), each expert's slots in that order.

    Returns:
      dispatch: [tokens, E, C] one-hot (token t occupies slot c of expert e)
      combine:  [tokens, E, C] dispatch * gate weight
    """
    tokens, k = gate_idx.shape
    flat_expert = gate_idx.reshape(-1)  # [tokens*k]
    onehot = F.one_hot(flat_expert, num_experts).float()  # [T*k, E]
    # Position of each (token, choice) pair within its expert's queue.
    pos = torch.cumsum(onehot, dim=0) - onehot
    slot = (pos * onehot).sum(-1)
    keep = slot < capacity
    slot = torch.where(keep, slot, torch.zeros_like(slot)).long()
    slot_onehot = F.one_hot(slot, capacity).float()
    dispatch_k = ((onehot * keep[:, None])[:, :, None]
                  * slot_onehot[:, None, :])
    dispatch_k = dispatch_k.reshape(tokens, k, num_experts, capacity)
    dispatch = dispatch_k.sum(1)
    combine = torch.einsum("tkec,tk->tec", dispatch_k, gate_vals)
    return dispatch, combine


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def capacity_for(tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots an expert takes: int(capacity_factor * tokens * k / experts),
    at least 1, padded up to a multiple of 8."""
    capacity = max(1, int(capacity_factor * tokens * top_k / num_experts))
    return -(-capacity // 8) * 8


def route(logits, num_experts: int, top_k: int, capacity_factor: float):
    """Top-k routing of router logits [tokens, E] at a fixed capacity:
    (dispatch, combine), each [tokens, E, C] (``_dispatch_mask``)."""
    gate_vals, gate_idx, _ = router_topk(logits, top_k)
    return _dispatch_mask(gate_idx, gate_vals, num_experts, capacity_for(
        logits.shape[0], num_experts, top_k, capacity_factor))


def expert_ffn(expert_in, w_in, w_out, axis_name: Optional[str] = None,
               activation: Callable = _gelu):
    """The experts on their slots: [E, C, model] -> [E, C, model], fp32.
    With an ep axis the slots go to their experts' ranks and back: a tiled
    all_to_all splits the expert dim into ep pieces (piece j = rank j's
    experts) and the pieces received concatenate on the slot dim, [E, C,
    m] -> [E_local, ep*C, m], source-rank-major; the strict inverse brings
    them back."""
    ep = axis_size(axis_name) if axis_name else 1
    if ep > 1:
        expert_in = all_to_all(expert_in, axis_name, split_axis=0,
                               concat_axis=1, tiled=True)
    h = activation(torch.einsum("ecm,emh->ech", expert_in, w_in.float()))
    y = torch.einsum("ech,ehm->ecm", h, w_out.float())
    if ep > 1:
        y = all_to_all(y, axis_name, split_axis=1, concat_axis=0, tiled=True)
    return y


def moe_ffn_local(x, router_w, w_in, w_out, *, num_experts: int,
                  top_k: int = 2, capacity_factor: float = 1.25,
                  axis_name: Optional[str] = "ep",
                  activation: Callable = _gelu
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN body (inside ``smap`` when axis_name is an ep axis).

    x: [tokens_local, model]; router_w: [model, E] (replicated);
    w_in: [E_local, model, hidden]; w_out: [E_local, hidden, model], the
    experts sharded over ``axis_name`` (E_local = E / ep; rank d owns the
    global experts [d*E_local, (d+1)*E_local)).

    Returns (y [tokens_local, model], aux_loss scalar).
    """
    tokens = x.shape[0]
    logits = x.float() @ router_w.float()
    gate_vals, gate_idx, probs = router_topk(logits, top_k)
    aux = load_balance_loss(probs, gate_idx, num_experts)
    dispatch, combine = _dispatch_mask(
        gate_idx, gate_vals, num_experts,
        capacity_for(tokens, num_experts, top_k, capacity_factor))
    expert_in = torch.einsum("tec,tm->ecm", dispatch, x.float())
    y = expert_ffn(expert_in, w_in, w_out, axis_name, activation)
    out = torch.einsum("tec,ecm->tm", combine, y)
    return out.to(x.dtype), aux


def _swiglu(h):
    """silu(first half) * second half of ``h [..., 2m]``, in fp32, returned
    in ``h``'s type."""
    a, b = h.float().chunk(2, dim=-1)
    return (F.silu(a) * b).to(h.dtype)


def _swiglu_grad(h, g):
    """The gradient of ``_swiglu`` at ``h`` for the output gradient ``g``
    (fp32), in ``h``'s type."""
    a, b = h.float().chunk(2, dim=-1)
    sig = torch.sigmoid(a)
    silu = a * sig
    da = g * b * sig * (1.0 + a * (1.0 - sig))
    return torch.cat([da, g * silu], dim=-1).to(h.dtype)


class _HeldExperts(torch.autograd.Function):
    """The held experts on their (token, choice) pairs, sorted by expert:
    ``x [T, d]``, ``w_in [E_held, d, 2m]``, ``w_out [E_held, m, d]``, the
    pairs' tokens ``tok [P]`` and router weights ``gates [P]`` (fp32),
    ``sizes`` the pairs of each held expert in order (host ints). Returns
    ``sum over a token's pairs of gate * expert(x)``, ``[T, d]`` in x's
    type (the sums in fp32). Saves the pairs' pre-activations; the backward
    is a device span ``moe.backward`` in the trace of the span the forward
    ran in."""

    @staticmethod
    def forward(ctx, x, w_in, w_out, tok, gates, sizes):
        xs = x[tok]
        pre = torch.empty(xs.shape[0], w_in.shape[-1], dtype=x.dtype,
                          device=x.device)
        y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        a = 0
        for e, n in enumerate(sizes):
            rows = slice(a, a + n)
            pre[rows] = xs[rows] @ w_in[e]
            out = _swiglu(pre[rows]) @ w_out[e]
            y.index_add_(0, tok[rows], out.float() * gates[rows, None])
            a += n
        ctx.save_for_backward(x, w_in, w_out, tok, gates, pre)
        span = tracing.current_span()
        ctx.sizes = sizes
        ctx.trace = None if span is None else span.trace_id
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        with tracing.device_span("moe.backward", dy, ctx.trace):
            x, w_in, w_out, tok, gates, pre = ctx.saved_tensors
            dys = dy[tok]
            dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            dw_in, dw_out = torch.zeros_like(w_in), torch.zeros_like(w_out)
            dgates = torch.empty_like(gates)
            a = 0
            for e, n in enumerate(ctx.sizes):
                rows = slice(a, a + n)
                a += n
                if n == 0:
                    continue
                act = _swiglu(pre[rows])
                g = (dys[rows] @ w_out[e].t()).float()
                dgates[rows] = (g * act.float()).sum(-1)
                dw_out[e] = act.t() @ (dys[rows].float()
                                       * gates[rows, None]).to(x.dtype)
                dpre = _swiglu_grad(pre[rows], g * gates[rows, None])
                dw_in[e] = x[tok[rows]].t() @ dpre
                dx.index_add_(0, tok[rows], (dpre @ w_in[e].t()).float())
        return dx.to(x.dtype), dw_in, dw_out, None, dgates, None


def moe_dropless(x, router_w, w_in, w_out, *, num_experts: int, top_k: int,
                 experts_held: Optional[Tuple[int, int]] = None):
    """Dropless top-k SwiGLU experts on the experts this rank holds.

    x: [tokens, d]; router_w: [d, num_experts], over every expert;
    w_in: [count, d, 2m] (gate half first, then up); w_out: [count, m, d],
    the experts ``start .. start + count - 1`` of ``experts_held = (start,
    count)`` (all of them when None).

    The router's fp32 logits pick each token's ``top_k`` experts, weighted
    by the softmax over the chosen logits (``router_topk``). The (token,
    choice) pairs are sorted by expert (stably, so token order within an
    expert); the held experts' pairs are one contiguous range of them, and
    each expert's products run over its own rows. Every pair routed to a
    held expert is computed.

    The routing and the products are one device span, ``moe.forward``, with
    the attributes ``pairs_held`` (the pairs sent to held experts) and
    ``max_expert_pairs`` (the largest held expert's pairs), nested under
    the thread's current span.

    Returns (y [tokens, d] in x's type, probs [tokens, num_experts] fp32
    (the softmax over all experts), counts [num_experts] (the pairs routed
    to each expert)), the last two for the load-balancing loss.
    """
    start, count = experts_held or (0, num_experts)
    if not (0 <= start and count == w_in.shape[0] == w_out.shape[0]
            and start + count <= num_experts):
        raise ValueError(f"experts_held {experts_held} does not fit "
                         f"{num_experts} experts and weights of "
                         f"{w_in.shape[0]}")
    with tracing.device_span("moe.forward", x) as span:
        logits = x.float() @ router_w.float()
        gate_vals, gate_idx, probs = router_topk(logits, top_k)
        flat = gate_idx.reshape(-1)
        counts = torch.bincount(flat, minlength=num_experts)
        order = torch.argsort(flat, stable=True)
        per_expert = counts.tolist()
        first = sum(per_expert[:start])
        sizes = per_expert[start:start + count]
        held = order[first:first + sum(sizes)]
        y = _HeldExperts.apply(x, w_in, w_out, held // top_k,
                               gate_vals.reshape(-1)[held], sizes)
        if span is not None:
            span.attributes["pairs_held"] = sum(sizes)
            span.attributes["max_expert_pairs"] = max(sizes, default=0)
    return y, probs, counts
