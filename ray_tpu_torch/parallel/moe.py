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
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

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
