"""Plain Granite 4.0-H training in fp32: the yardstick ``correct`` is decided
by for the hybrid configuration.

It imports torch, math and typing, and from the GPT-2 reference beside it
the fp32 settings, the fp8 rounding of the control and Adafactor: nothing
of the program under test, of the JAX package or of JAX. It takes the
benchmark's inputs (the initial weights by the program's parameter names,
the token batches made from the seed) and computes the training step from
the equations of ``transformers``' ``granitemoehybrid`` modeling code:

- the embedding times ``embedding_multiplier``; each layer of
  ``layer_types``: ``x + mixer(rms_norm(x)) * residual_multiplier``, then
  ``x + (experts(h) + shared(h)) * residual_multiplier``, ``h =
  rms_norm(x)``; the final RMSNorm; the tied head's logits over
  ``logits_scaling``; the mean next-token cross-entropy plus
  ``router_aux_loss_coef`` times the load-balancing loss over every
  layer's router logits at once (``load_balancing_loss_func``);
- the Mamba-2 mixer: ``in_proj`` to z, xBC, dt; the causal depthwise conv
  written as a sum of shifted products, SiLU; ``dt = softplus(dt +
  dt_bias)``, ``A = -exp(A_log)``; the scan in the SSD's quadratic form,
  ``y_t = sum_{s <= t} (C_t . B_s) exp(sum_{r=s+1..t} dt_r A) dt_s x_s``,
  the decays taken from fp64 cumulative sums, plus ``D x_t``; the gated
  RMSNorm ``rms_norm(y * silu(z))``; ``out_proj``;
- attention: q, k, v without rotation, each KV head repeated for its
  query heads, causal softmax attention with scores scaled by
  ``attention_multiplier``, the output projection;
- the experts: the router's fp32 logits over every expert, the top
  ``num_experts_per_tok`` weighted by the softmax of the chosen logits
  (the source's ``GraniteMoeHybridTopKGating``), each held expert a SwiGLU
  on the tokens that chose it, added back weighted; the shared SwiGLU.

Only the experts ``held = (first, count)`` are computed, the share the
program holds: what the other experts would add is left out here too.
Weights are ``[in, out]``, applied as ``y @ w``, as the program holds them.

Every product and sum is fp32 with TF32 off (``fp32_products``); the
parameters are stored in the configuration's type, each update computed in
fp32 and ``p + u`` rounded once, with optax's Adafactor on every parameter
as a leaf of its own. ``precision="fp8"`` is the control: every tensor the
program holds in bf16 (each product's operands and results, the conv's
output, the embeddings, the residual stream) held in float8 e4m3 with a
per-tensor scale instead; norms, the scan, softmax, the logits and the
loss stay fp32, as in the program.

Memory is bounded by recomputation: each layer, the Mamba mixer's parts
before and after the scan, each block of the scan's rows, each chunk of
attention's queries and each chunk of the loss's tokens runs under
``torch.utils.checkpoint``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .gpt2 import Adafactor, _mm, _round, fp32_products

ATTN_CHUNK = 256
CE_CHUNK = 4096
# The scan's rows in this many blocks, and within them its heads in blocks
# whose fp32 decays take at most SCAN_BYTES.
ROW_BLOCKS = 8
SCAN_BYTES = 1 << 30
# Parameters whose last axis holds the gate and the up projection.
PARTS = {"experts_in": 2, "shared_in": 2}
EXPERT_LEAVES = ("experts_in", "experts_out")


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def causal_conv(x, w, b):
    """Depthwise causal conv of x ``[B, S, C]`` with w ``[C, K]`` and bias:
    ``y_t = b + sum_j w[:, j] x_{t - K + 1 + j}``, zeros before the start."""
    k, s = w.shape[1], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = b
    for j in range(k):
        out = out + xp[:, j:j + s] * w[:, j]
    return out


def _scan_rows(x, dt, A, G, q0: int):
    """Rows q0 .. q1 - 1 of the quadratic form for a block of heads: x
    ``[B, S, h, p]``, dt ``[B, S, h]``, A ``[h]``, G ``[B, q1 - q0, q1]``
    the rows of C B^T, positions 0 .. q1 - 1 read -> ``[B, q1 - q0, h,
    p]``.

    The decay's exponent, the sum of ``dt A`` over s+1..t, comes from the
    fp64 cumulative sum cs: for s <= q0 as ``(cs_t - cs_q0) + (cs_q0 -
    cs_s)``, each part rounded to fp32 (both have the sign of the sum, so
    the sum is exact to fp32's rounding of its size); for q0 < s as ``cs_t
    - cs_s`` in fp64, then rounded."""
    q1 = G.shape[2]
    x, dt = x[:, :q1], dt[:, :q1]
    cs = torch.cumsum((dt * A).double(), dim=1).transpose(1, 2)  # [B, h, k]
    start = cs[..., q0:q0 + 1]
    exponent = ((cs[..., q0:] - start).float()[..., :, None]
                + (start - cs).float()[..., None, :])            # [B, h, r, k]
    exponent[..., q0:] = (cs[..., q0:, None] - cs[..., None, q0:]).float()
    keep = torch.ones(q1 - q0, q1, dtype=torch.bool,
                      device=x.device).tril_(q0)
    decay = exponent.masked_fill_(~keep, -math.inf).exp_()
    y = (decay * G[:, None]) @ (x * dt[..., None]).transpose(1, 2)
    return y.transpose(1, 2)


def ssd_quadratic(x, dt, A, B, C):
    """The scan without the skip: x ``[B, S, h, p]``, dt ``[B, S, h]``, A
    ``[h]``, B and C ``[B, S, n]`` -> ``[B, S, h, p]``, in blocks of rows
    and, within them, of heads."""
    b, s, h, _ = x.shape
    rows = -(-s // ROW_BLOCKS)
    heads = max(1, min(h, SCAN_BYTES // (4 * b * rows * s)))
    outs = []
    for q0 in range(0, s, rows):
        q1 = min(s, q0 + rows)
        G = C[:, q0:q1] @ B[:, :q1].transpose(1, 2)
        outs.append(torch.cat([
            checkpoint(_scan_rows, xh, dth, Ah, G, q0, use_reentrant=False)
            for xh, dth, Ah in zip(x.split(heads, 2), dt.split(heads, 2),
                                   A.split(heads))], dim=2))
    return torch.cat(outs, dim=1)


def _mamba_in(h, w: Dict, conf: Dict, precision: str):
    """z, the conv's activated output x, B, C, and dt after its softplus."""
    r = lambda t: _round(t, precision)  # noqa: E731
    heads, p, n = conf["mamba_n_heads"], conf["mamba_d_head"], \
        conf["mamba_d_state"]
    di = heads * p
    z, xbc, dt = r(_mm(h, w["mamba.in_proj"], precision)).split(
        [di, di + 2 * n, heads], -1)
    xbc = r(F.silu(causal_conv(xbc, w["mamba.conv_w"], w["mamba.conv_b"])))
    x, B, C = xbc.split([di, n, n], -1)
    return (z, x.unflatten(-1, (heads, p)), B, C,
            F.softplus(dt + w["mamba.dt_bias"]))


def _mamba_out(y, z, x, w: Dict, conf: Dict, precision: str):
    """The skip, the gated norm and the out-projection of the scan's y."""
    y = y + w["mamba.D"][:, None] * x
    y = rms_norm(y.flatten(2) * F.silu(z), w["mamba.norm"],
                 conf["rms_norm_eps"])
    return _round(_mm(y, w["mamba.out_proj"], precision), precision)


def mamba(h, w: Dict, conf: Dict, precision: str):
    """The mixer, its parts before and after the scan each recomputed in
    the backward on their own (the scan in blocks of rows)."""
    z, x, B, C, dt = checkpoint(_mamba_in, h, w, conf, precision,
                                use_reentrant=False)
    y = ssd_quadratic(x, dt, -torch.exp(w["mamba.A_log"]), B, C)
    return checkpoint(_mamba_out, y, z, x, w, conf, precision,
                      use_reentrant=False)


def _attn_rows(q, k, v, q0: int, scale: float, precision: str):
    s = _mm(q * scale, k.transpose(-1, -2), precision)
    above = torch.ones(q.shape[2], k.shape[2] - q0, dtype=torch.bool,
                       device=q.device).triu_(1)
    s[..., q0:].masked_fill_(above, float("-inf"))
    return _mm(torch.softmax(s, dim=-1), v, precision)


def attention(h, w: Dict, conf: Dict, precision: str):
    r = lambda t: _round(t, precision)  # noqa: E731
    b, s, d = h.shape
    heads, kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = d // heads
    q = r(_mm(h, w["attn.wq"], precision)).view(b, s, heads, hd)
    k = r(_mm(h, w["attn.wk"], precision)).view(b, s, kv, hd)
    v = r(_mm(h, w["attn.wv"], precision)).view(b, s, kv, hd)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    k, v = (t.repeat_interleave(heads // kv, dim=1) for t in (k, v))
    scale = conf["attention_multiplier"]
    o = torch.cat([checkpoint(_attn_rows, q[:, :, q0:q0 + ATTN_CHUNK],
                              k[:, :, :q0 + ATTN_CHUNK],
                              v[:, :, :q0 + ATTN_CHUNK], q0, scale,
                              precision, use_reentrant=False)
                   for q0 in range(0, s, ATTN_CHUNK)], dim=2)
    o = r(o).transpose(1, 2).reshape(b, s, d)
    return r(_mm(o, w["attn.wo"], precision))


def _swiglu(h, w_in, w_out, precision: str):
    r = lambda t: _round(t, precision)  # noqa: E731
    gate, up = r(_mm(h, w_in, precision)).chunk(2, dim=-1)
    return r(_mm(r(F.silu(gate) * up), w_out, precision))


def experts(h, w: Dict, conf: Dict, held: Tuple[int, int], precision: str):
    """The routed experts held and the shared expert on h ``[T, d]``;
    returns (their sum, the router's logits ``[T, E]``)."""
    logits = _mm(h, w["moe.router"], precision)
    top, idx = logits.topk(conf["num_experts_per_tok"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    y = torch.zeros_like(h)
    for j in range(held[1]):
        tok, slot = (idx == held[0] + j).nonzero(as_tuple=True)
        out = _swiglu(h[tok], w["moe.experts_in"][j],
                      w["moe.experts_out"][j], precision)
        y = y.index_add(0, tok, out * gates[tok, slot][:, None])
    shared = _swiglu(h, w["moe.shared_in"], w["moe.shared_out"], precision)
    return y + shared, logits


def layer(x, w: Dict, kind: str, conf: Dict, held: Tuple[int, int],
          precision: str):
    r = lambda t: _round(t, precision)  # noqa: E731
    eps, mult = conf["rms_norm_eps"], conf["residual_multiplier"]
    mixer = mamba if kind == "mamba" else attention
    x = r(x + mixer(rms_norm(x, w["input_norm"], eps), w, conf, precision)
          * mult)
    h = rms_norm(x, w["post_norm"], eps)
    y, logits = experts(h.reshape(-1, h.shape[-1]), w, conf, held,
                        precision)
    return r(x + y.view_as(x) * mult), logits


def load_balancing(logits, num_experts: int, top_k: int):
    """``load_balancing_loss_func`` without a mask: experts times the sum
    over experts of the share of (row, choice) pairs that chose the expert
    and its mean probability, over the rows of every layer at once."""
    probs = torch.softmax(logits, dim=-1)
    chosen = probs.topk(top_k, dim=-1).indices.reshape(-1)
    share = torch.bincount(chosen, minlength=num_experts).float() \
        / logits.shape[0]
    return num_experts * (share * probs.mean(0)).sum()


def _nll_sum(x, embed, targets, scaling: float, precision: str):
    logits = _mm(x, embed.t(), precision) / scaling
    gold = logits.gather(-1, targets[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def loss(params: Dict[str, torch.Tensor], tokens: torch.Tensor, conf: Dict,
         held: Tuple[int, int], precision: str = "fp32") -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` [B, S + 1] plus the
    router's auxiliary loss."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x = _round(F.embedding(inputs, params["embed"])
               * conf["embedding_multiplier"], precision)
    all_logits = []
    for i, kind in enumerate(conf["layer_types"]):
        prefix = f"layers.{i}."
        w = {n[len(prefix):]: t for n, t in params.items()
             if n.startswith(prefix)}
        x, logits = checkpoint(layer, x, w, kind, conf, held, precision,
                               use_reentrant=False)
        all_logits.append(logits)
    x = rms_norm(x, params["final_norm"], conf["rms_norm_eps"])
    xf, tf = x.reshape(-1, x.shape[-1]), targets.reshape(-1)
    total = x.new_zeros(())
    for i in range(0, xf.shape[0], CE_CHUNK):
        total = total + checkpoint(_nll_sum, xf[i:i + CE_CHUNK],
                                   params["embed"], tf[i:i + CE_CHUNK],
                                   conf["logits_scaling"], precision,
                                   use_reentrant=False)
    aux = load_balancing(torch.cat(all_logits), all_logits[0].shape[-1],
                         conf["num_experts_per_tok"])
    return total / xf.shape[0] + conf["router_aux_loss_coef"] * aux


def unit_norms(leaf: str, t: torch.Tensor) -> torch.Tensor:
    """fp32 L2 norms of a parameter given as ``[1, ...]``: one, or one an
    expert of an expert leaf and one a part of a leaf that fuses the gate
    and the up projection (``PARTS``), expert-major."""
    kind = leaf.rsplit(".", 1)[-1]
    t = t.float()
    if kind in EXPERT_LEAVES:
        t = t.flatten(0, 1)
    k = PARTS.get(kind, 1)
    t = t.reshape(t.shape[0], -1, k, t.shape[-1] // k)
    return t.transpose(1, 2).flatten(2).norm(dim=2).flatten()


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: unit_norms(n, t[None]) for n, t in tensors.items()}


def train(params: Dict[str, torch.Tensor], batches: List[torch.Tensor],
          conf: Dict, held: Tuple[int, int], lr: float,
          precision: str = "fp32",
          param_dtype: torch.dtype = torch.bfloat16) -> Dict:
    """``len(batches)`` training steps from ``params`` (not changed), the
    parameters stored in ``param_dtype``. Returns each step's loss, the
    first step's gradient norms and the norms of the parameters' change
    after the last step (``leaf_norms``)."""
    p0 = {n: t.detach() for n, t in params.items()}
    cur = {n: t.detach().float().clone().requires_grad_()
           for n, t in params.items()}
    opt = Adafactor(lr)
    losses, first = [], None
    with fp32_products():
        for tokens in batches:
            value = loss(cur, tokens, conf, held, precision)
            grads = dict(zip(cur, torch.autograd.grad(value, list(
                cur.values()))))
            losses.append(float(value.detach()))
            if first is None:
                first = leaf_norms(grads)
            with torch.no_grad():
                upd = opt.updates(cur, grads)
                for n, p in cur.items():
                    p.copy_((p + upd[n]).to(param_dtype).float())
            del grads, upd
    with torch.no_grad():
        change = leaf_norms({n: cur[n] - p0[n].float() for n in cur})
    return {"losses": losses, "grad_norms": first, "change_norms": change}

