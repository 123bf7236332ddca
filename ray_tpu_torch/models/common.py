"""Model-building primitives: counterpart of the JAX package's
``models/common.py``.

Parameters live in ``nn.Module``s here; the functions below are the plain
tensor pieces the models share. Norms and the loss compute in fp32
whatever the activation dtype, as in the JAX package.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# LayerNorm and RMSNorm in fp32, returned in x's dtype: the CUDA kernels for
# tensors on a card, the plain composites on the CPU and for DTensors.
from ..ops.norm import layer_norm, rms_norm  # noqa: F401


def truncated_normal(shape, generator: Optional[torch.Generator] = None,
                     stddev: float = 0.02, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """``stddev`` times a standard normal truncated to [-2, 2], as
    ``jax.random.truncated_normal(key, -2, 2)`` draws it (other numbers:
    the generators differ)."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (out * stddev).to(dtype)


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def param_bytes(module: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())


def cast_floating(tree, dtype: torch.dtype):
    """Every floating-point tensor of ``tree`` in ``dtype``, the others as
    they are: a module is cast in place (its parameters and buffers) and
    returned; a dict, list or tuple of tensors comes back as a new one."""
    if isinstance(tree, nn.Module):
        return tree.to(dtype)  # moves floating-point tensors only
    if isinstance(tree, Mapping):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree.to(dtype) if tree.is_floating_point() else tree


def cross_entropy_sums(logits, targets, ignore_id: int = -1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked token CE in fp32 as (nll_sum, token_count), summable across
    sequence/loss chunks."""
    logits = logits.float()
    mask = (targets != ignore_id).float()
    targets = targets.clamp_min(0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_cross_entropy(x, wte, targets, loss_chunk: int):
    """(nll_sum, count) of the tied head's logits of x [..., d] against
    targets, in chunks of tokens (even chunks rounded to 256 tokens, as the
    JAX package cuts them), each under ``torch.utils.checkpoint``: only one
    chunk's fp32 logits are live, and the backward recomputes them."""
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    tf = targets.reshape(-1)
    n = xf.shape[0]
    n_chunks = max(1, -(-n // loss_chunk))
    per_chunk = -(-n // n_chunks)
    chunk = min(n, -(-per_chunk // 256) * 256) if n >= 256 else n
    pad = (-n) % chunk
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
        tf = F.pad(tf, (0, pad), value=-1)  # ignore_id
    nll_sum = torch.zeros((), device=x.device)
    denom = torch.zeros((), device=x.device)
    for xi, ti in zip(xf.split(chunk), tf.split(chunk)):
        nll, count = checkpoint(_chunk_loss, xi, wte, ti, use_reentrant=False)
        nll_sum = nll_sum + nll
        denom = denom + count
    return nll_sum, denom


def _chunk_loss(xi, wte, ti):
    return cross_entropy_sums(lm_logits(xi, wte), ti)


def expand_kv_heads(k, v, heads: int, group: int, q0: int = 0, k0: int = 0):
    """Grouped-query attention's KV heads, one for each query head: k, v
    ``[B, Hkv, S, hd]`` -> ``[B, heads, S, hd]``, query head ``q0 + i``
    reading KV head ``(q0 + i) // group``, of which this tensor holds the
    heads from ``k0`` on (``q0``, ``k0``: the first heads a rank holds)."""
    hk = k.shape[1]
    if q0 // group < k0 or (q0 + heads - 1) // group >= k0 + hk:
        raise ValueError(
            f"query heads [{q0}, {q0 + heads}) read KV heads this rank "
            f"does not hold ([{k0}, {k0 + hk}))")
    idx = (q0 + torch.arange(heads, device=k.device)) // group - k0
    return k.index_select(1, idx), v.index_select(1, idx)


def cross_entropy_loss(logits, targets, ignore_id: int = -1):
    """Token-level CE in fp32; returns (mean_loss, denom)."""
    nll_sum, count = cross_entropy_sums(logits, targets, ignore_id)
    denom = count.clamp_min(1.0)
    return nll_sum / denom, denom


class _LMHead(torch.autograd.Function):
    """fp32 logits ``x @ w^T`` from 16-bit operands, as the JAX package's
    ``dot_general(..., preferred_element_type=fp32)``. On CUDA one GEMM
    writes fp32 directly; the backward takes the cotangent in the operand
    dtype for the two tensor-core GEMMs."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda and x.dtype != torch.float32:
            return torch.mm(x, w.t(), out_dtype=torch.float32)
        return x.float() @ w.float().t()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w.to(x.dtype), (g.t() @ x).to(w.dtype)


def lm_logits(x, w):
    """Tied LM head: fp32 logits of ``x [..., d]`` against ``w [V, d]``."""
    shape = x.shape[:-1]
    return _LMHead.apply(x.reshape(-1, x.shape[-1]), w).reshape(*shape, -1)
