"""Ring attention: sequence/context parallelism over a mesh axis.
Counterpart of the JAX package's ``parallel/ring.py``.

The sequence is sharded over the ``sp`` axis; K/V shards rotate around the
ring (``collective.ppermute``) while each rank accumulates attention for
its local Q shard with the online-softmax merge.

Layout: q/k/v ``[batch, heads, seq, head_dim]`` with ``seq`` sharded, shard
r holding positions ``[r*S_local, (r+1)*S_local)``. The ``*_local``
bodies run on local shards (inside ``sharding.smap``); ``ring_attention``
is the entry point on whole tensors.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.attention import attention_with_lse
from .collective import axis_index, axis_size, ppermute
from .sharding import P, smap

_NEG_INF = -1e30


def _ring(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


def ring_attention_local(q, k, v, axis_name: str = "sp",
                         causal: bool = True,
                         scale: Optional[float] = None):
    """Per-shard ring attention body, differentiable (fp32 einsum blocks).

    q/k/v: local shards [B, H, S_local, D]. The last step's rotation, whose
    result the JAX body discards, is not sent.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n = axis_size(axis_name)
    rank = axis_index(axis_name)
    b, h, s_local, d = q.shape

    qf = q.float() * scale
    q_pos = rank * s_local + torch.arange(s_local, device=q.device)
    m = torch.full((b, h, s_local, 1), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, s_local, 1), device=q.device)
    acc = torch.zeros((b, h, s_local, d), device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        src = (rank - step) % n  # whose K/V shard this rank holds
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_cur.float())
        if causal:
            k_pos = src * s_local + torch.arange(s_local, device=q.device)
            s = s.masked_fill(q_pos[:, None] < k_pos[None, :], _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        p = p.masked_fill(s <= _NEG_INF / 2, 0.0)
        alpha = torch.exp((m - m_new).clamp_min(-80.0))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v_cur.float())
        m = m_new
        if step + 1 < n:
            k_cur = ppermute(k_cur, axis_name, _ring(n))
            v_cur = ppermute(v_cur, axis_name, _ring(n))
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / safe_l).to(q.dtype)


def ring_flash_attention_local(q, k, v, axis_name: str = "sp",
                               causal: bool = True,
                               scale: Optional[float] = None,
                               block_impl: str = "auto"):
    """Ring attention whose per-step block is the flash forward
    (``attention_with_lse``: K1 or K4 on the card, by dtype and head dim;
    the plain version on the CPU). Partial outputs merge through their
    log-sum-exp. Forward only.

    Three block modes under causal masking: the diagonal step (src ==
    rank) is causal flash, earlier shards (src < rank) attend fully, later
    shards are skipped (the JAX body's lse of -1e30, whose merge weight is
    exactly 0, so the merge is skipped too). Rank r launches the kernel
    r + 1 times causal, n times not.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n = axis_size(axis_name)
    rank = axis_index(axis_name)
    out = torch.zeros(q.shape, device=q.device)
    lse = torch.full(q.shape[:3], _NEG_INF, device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        src = (rank - step) % n
        if not causal or src <= rank:
            o_i, lse_i = attention_with_lse(
                q, k_cur, v_cur, causal=causal and src == rank, scale=scale,
                impl=block_impl)
            new_lse = torch.logaddexp(lse, lse_i)
            w_old = torch.exp(lse - new_lse)[..., None]
            w_new = torch.exp(lse_i - new_lse)[..., None]
            out = out * w_old + o_i.float() * w_new
            lse = new_lse
        if step + 1 < n:
            k_cur = ppermute(k_cur, axis_name, _ring(n))
            v_cur = ppermute(v_cur, axis_name, _ring(n))
    return out.to(q.dtype)


def ring_attention(q, k, v, mesh, axis_name: str = "sp",
                   causal: bool = True,
                   batch_axes=("dp", "fsdp"), heads_axis="tp",
                   impl: str = "einsum"):
    """Sharded entry point: q/k/v [B, H, S, D] whole on every rank (or
    DTensors); S must divide by the sp axis size. ``impl='flash'`` uses the
    flash block per step (forward only); ``'einsum'`` is the
    differentiable training body. Returns a DTensor sharded as the input
    spec."""
    body = (ring_flash_attention_local if impl == "flash"
            else ring_attention_local)
    spec = P(batch_axes, heads_axis, axis_name, None)
    fn = smap(lambda q, k, v: body(q, k, v, axis_name=axis_name,
                                   causal=causal),
              mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v)
