"""Llama family (RMSNorm, RoPE, GQA, SwiGLU) with the KV-cache paths of
the serving engine: counterpart of the JAX package's ``models/llama.py``.

Parameters keep the JAX package's names and layouts (``wq`` is ``[d, d]``,
applied as ``y @ w``), one ``Block`` per layer where JAX stacks them
``[L, ...]``; ``convert.py`` carries a JAX pytree across.

Three families of functions, each taking the ``Llama`` module where the
JAX package takes its params pytree (the config comes with the module):

- ``Llama.forward`` / ``Llama.loss_fn``: the training and prefill path.
  Attention goes through ``ops.attention.attention``: on the card the
  flash kernels (K1 forward, K2/K3 under autograd), their plain versions
  on the CPU.
- The dense KV cache ``[L, B, Hkv, max_seq, hd]`` (``decode_step``,
  ``decode_slots``, ``decode_slots_with_prefill``, ``prefill_chunk``,
  ``generate``): the single-request references.
- The paged KV cache, ONE fused array ``[L, 2, num_pages, page_size, Hkv,
  hd]`` (0 = K, 1 = V) in heads-minor page order, reached through a
  ``[rows, max_seq // page_size]`` page table (``decode_slots_paged``,
  ``prefill_chunk_paged``, ``decode_slots_with_prefill_paged``,
  ``copy_pages``, ``write_pages``): what the serving engine runs. Physical
  page 0 is the reserved scratch page: every invalid write (parked rows
  at ``pos >= max_seq``, chunk-tail padding) is routed there, and
  unallocated table entries point at it. Positions in unallocated logical
  pages are always past the row's position, so they are gathered but
  masked, and weigh exactly 0.

JAX updates the caches functionally and the engine donates them; here
every cache function writes the cache tensors in place and returns the
same dict. Per-row vectors are tensors on the cache's device. Scalars (a slot, a
chunk start, a count) are Python ints, or, in the paged functions the
engine runs, one-element tensors on the device too, so that a call can be
captured once in a CUDA graph and replayed with new values.

The cache attention is plain PyTorch, as the JAX package's is XLA gather
and einsum (no Pallas kernel): scores are the exact product of the
16-bit operands accumulated in fp32 (the gathered view is upcast, which
is exact), masked with -1e30, softmax in fp32, probabilities cast to the
cache dtype before P·V.

Sharding rules (``rules``), on parameters placed as DTensors by
``parallel.sharding.place`` with ``Llama.logical_axes()``:

- ``forward``/``loss_fn`` constrain at the JAX package's three sites and
  run attention (rope, the grouping of query heads onto KV heads, the
  kernels) on each rank's heads inside an ``smap`` region, as GPT-2 does;
- the paged functions run on each rank's local shards (``_Shards``)
  under rules that map "qkv", "kv", "mlp" and "vocab" to one mesh axis,
  tp (``SlotEngine.SERVE_RULES``): rank r holds H/tp query heads, Hkv/tp
  KV heads (of every layer and every page), d_mlp/tp columns of the gate
  and up products and rows of ``w_down``, and vocab/tp rows of ``wte``.
  The ``wo`` and ``w_down`` products and the embedding lookup (each rank
  its own vocab rows, zeros elsewhere) are summed over tp in fp32, and the
  LM head's vocab shards are gathered, so every rank samples from the
  whole row. Query head h reads KV head h // (H / Hkv): a rank's block of
  query heads lines up with its block of KV heads because tp divides Hkv,
  which ``_Shards`` checks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import default_device
from .. import random as trandom
from ..ops.attention import attention as attention_op
from ..parallel.collective import all_gather, axis_index, axis_size, psum
from ..parallel.sharding import (P, constrain, current_mesh, is_dtensor,
                                 mesh_sizes, smap, spec_axes, spec_for,
                                 use_mesh)
from .common import (cross_entropy_loss, cross_entropy_sums, expand_kv_heads,
                     lm_logits, rms_norm, truncated_normal)

_NEG = -1e30


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq: int = 2048
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    d_model: int = 4096
    d_mlp: int = 11008
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


CONFIGS: Dict[str, LlamaConfig] = {
    "llama2-7b": LlamaConfig(),
    "llama-tiny": LlamaConfig(vocab_size=512, max_seq=128, num_layers=2,
                              num_heads=4, num_kv_heads=2, d_model=64,
                              d_mlp=172, dtype=torch.float32, remat=False),
    "llama2-13b": LlamaConfig(num_layers=40, num_heads=40, num_kv_heads=40,
                              d_model=5120, d_mlp=13824),
    # TinyLlama-1.1B geometry: the serve-bench model (~2.2 GB of bf16
    # params, an 8-slot KV pool to spare).
    "llama-1b": LlamaConfig(num_layers=22, num_heads=32, num_kv_heads=4,
                            d_model=2048, d_mlp=5632, max_seq=2048),
}

# Logical axes of cache["kv"]: the heads axis shards under the "kv" rule
# (the serving engine maps it to tp).
PAGED_KV_AXES = (None, None, None, None, "kv", None)


def block_logical_axes() -> Dict[str, tuple]:
    """Logical axes of one block's parameters: the JAX package's
    ``param_axes()`` blocks without the leading "layers" (one module a
    layer here)."""
    return {"attn_norm": (None,), "wq": ("embed", "qkv"),
            "wk": ("embed", "kv"), "wv": ("embed", "kv"),
            "wo": ("qkv", "embed"), "ffn_norm": (None,),
            "w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}


def _rope_tables(positions, head_dim: int, theta: float):
    """(cos, sin) of the rotary angles, fp32, broadcastable against
    [B, H, S, head_dim // 2]. positions: [S] or [B, S]. Every layer of a
    call rotates by the same tables, so a call computes them once."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=positions.device)
                             / head_dim))
    if positions.ndim == 1:
        angles = (positions[:, None].float() * freqs[None, :])[None, None]
    else:
        angles = positions[:, None, :, None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def _rotate(x, rot):
    cos, sin = rot
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary embeddings on INTERLEAVED pairs (``x[..., ::2]``,
    ``x[..., 1::2]``). x: [B, H, S, D]; positions: [S] or [B, S]. The
    rotation is fp32, cast back to x's dtype."""
    return _rotate(x, _rope_tables(positions, x.shape[-1], theta))


def _repeat_kv(x, n_rep: int):
    """[B, Hkv, S, D] -> [B, Hkv * n_rep, S, D], each head repeated in
    place (``jnp.repeat`` on axis 1)."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=1)


def _qkv(w, x, rot, heads: int, kv_heads: int):
    """x [B, T, D] -> q [B, heads, T, hd], k and v [B, kv_heads, T, hd]
    through one layer's weights ``w`` (a ``Block``, or one rank's shards of
    one), q and k rotated by ``rot`` (``_rope_tables`` of the positions;
    None leaves them unrotated)."""
    b, t, _ = x.shape
    hd = w.wk.shape[1] // kv_heads
    y = rms_norm(x, w.attn_norm)
    q = (y @ w.wq.to(y.dtype)).reshape(b, t, heads, hd).transpose(1, 2)
    k = (y @ w.wk.to(y.dtype)).reshape(b, t, kv_heads, hd).transpose(1, 2)
    v = (y @ w.wv.to(y.dtype)).reshape(b, t, kv_heads, hd).transpose(1, 2)
    if rot is None:
        return q, k, v
    return _rotate(q, rot), _rotate(k, rot), v


def _tp_sum(x, sh: Optional["_Shards"]):
    """``x`` summed over the tp group of ``sh`` in fp32 (the partial
    products of the row-parallel weights); ``x`` itself on one rank."""
    if sh is None or sh.n == 1:
        return x
    with use_mesh(sh.mesh):
        return psum(x.float(), sh.axis).to(x.dtype)


def _attn_out(w, x, o, sh=None, rules=None):
    """Residual add of the attention output o [B, T, heads * hd] through
    ``wo`` (summed over tp under ``sh``)."""
    out = _tp_sum(o @ w.wo.to(o.dtype), sh)
    return x + constrain(out, ("batch", "seq", None), rules)


def _ffn(w, x, sh=None, rules=None):
    """Residual SwiGLU MLP (the ``w_down`` product summed over tp under
    ``sh``)."""
    y = rms_norm(x, w.ffn_norm)
    gate = F.silu(y @ w.w_gate.to(y.dtype))
    up = y @ w.w_up.to(y.dtype)
    hidden = constrain(gate * up, ("batch", "seq", "mlp"), rules)
    out = _tp_sum(hidden @ w.w_down.to(y.dtype), sh)
    return x + constrain(out, ("batch", "seq", None), rules)


def _first_head(spec) -> int:
    """Inside an smap body: the position, among the ranks dim 1 of
    ``spec`` is split over, of this rank's block of heads."""
    entry = spec[1] if len(spec) > 1 else None
    i = 0
    for a in () if entry is None else (
            (entry,) if isinstance(entry, str) else entry):
        i = i * axis_size(a) + axis_index(a)
    return i


def _causal_attention(q, k, v, rot, group: int, rules):
    """The training path's attention: q [B, H, S, hd] and k, v [B, Hkv, S,
    hd] projected, not yet rotated; returns [B, H, S, hd]. Rope on q and k,
    query head h reads KV head h // ``group``, then the causal kernels (K1
    forward, K2/K3 under autograd; their plain versions on the CPU).
    DTensors run in an ``smap`` region on the heads each rank holds ("heads"
    for q, "kv" for k and v)."""
    sharded = is_dtensor(q)
    qs = spec_for(("batch", "heads", None, None), rules)
    ks = spec_for(("batch", "kv", None, None), rules)

    def body(q, k, v, cos, sin):
        q, k = _rotate(q, (cos, sin)), _rotate(k, (cos, sin))
        hq, hk = q.shape[1], k.shape[1]
        q0, k0 = ((_first_head(qs) * hq, _first_head(ks) * hk) if sharded
                  else (0, 0))
        k, v = expand_kv_heads(k, v, hq, group, q0, k0)
        return attention_op(q.contiguous(), k, v, causal=True)

    if sharded:
        return smap(body, current_mesh(), in_specs=(qs, ks, ks, P(), P()),
                    out_specs=qs)(q, k, v, *rot)
    return body(q, k, v, *rot)


class Block(nn.Module):
    """One pre-norm Llama block (``_block`` in the JAX package)."""

    def __init__(self, cfg: LlamaConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        d, m, L = cfg.d_model, cfg.d_mlp, cfg.num_layers
        kv = cfg.num_kv_heads * cfg.head_dim
        proj_std = 0.02 / math.sqrt(2 * L)
        tn = lambda shape, std=0.02: nn.Parameter(
            truncated_normal(shape, generator, stddev=std, device=device))
        self.attn_norm = nn.Parameter(torch.ones(d, device=device))
        self.wq = tn((d, d))
        self.wk = tn((d, kv))
        self.wv = tn((d, kv))
        self.wo = tn((d, d), proj_std)
        self.ffn_norm = nn.Parameter(torch.ones(d, device=device))
        self.w_gate = tn((d, m))
        self.w_up = tn((d, m))
        self.w_down = tn((m, d), proj_std)

    def qkv(self, x, rot):
        """x [B, T, D] -> q [B, H, T, hd], k and v [B, Hkv, T, hd], q and
        k rotated by ``rot`` (``_rope_tables`` of the positions)."""
        return _qkv(self, x, rot, self.cfg.num_heads, self.cfg.num_kv_heads)

    def forward(self, x, rot, rules=None):
        b, s, d = x.shape
        cfg = self.cfg
        q, k, v = _qkv(self, x, None, cfg.num_heads, cfg.num_kv_heads)
        o = _causal_attention(q, k, v, rot,
                              cfg.num_heads // cfg.num_kv_heads, rules)
        x = _attn_out(self, x, o.transpose(1, 2).reshape(b, s, d),
                      rules=rules)
        return _ffn(self, x, rules=rules)


class Llama(nn.Module):
    """Llama LM. Parameters are created fp32 on ``device`` (``cuda`` unless
    the caller asks for the CPU) from ``generator``, which must live on
    that device; cast with ``.to(cfg.dtype)`` to serve in bf16."""

    def __init__(self, cfg: LlamaConfig,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dev = default_device(device)
        self.cfg = cfg
        self.wte = nn.Parameter(truncated_normal(
            (cfg.vocab_size, cfg.d_model), generator, device=dev))
        self.blocks = nn.ModuleList(Block(cfg, generator, dev)
                                    for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, device=dev))

    def logical_axes(self) -> Dict[str, tuple]:
        """Logical axes of every parameter, by name: the JAX package's
        ``param_axes()``, a block's without the "layers" dim."""
        axes = {"wte": ("vocab", "embed"), "final_norm": (None,)}
        for name, ax in block_logical_axes().items():
            for i in range(self.cfg.num_layers):
                axes[f"blocks.{i}.{name}"] = ax
        return axes

    def forward_features(self, tokens, rules=None):
        """tokens [B, S] -> final-normed hidden states [B, S, D].
        ``cfg.remat`` recomputes each block in the backward, and only when
        gradients are being taken."""
        cfg = self.cfg
        x = _embed_lookup(self.wte, tokens, rules).to(cfg.dtype)
        rot = _rot(torch.arange(tokens.shape[1], device=tokens.device), cfg)
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = (checkpoint(block, x, rot, rules, use_reentrant=False)
                 if remat else block(x, rot, rules))
        return rms_norm(x, self.final_norm)

    def forward(self, tokens, rules=None):
        """tokens [B, S] -> fp32 logits [B, S, vocab] (training/prefill);
        vocab-sharded under a mesh."""
        x = self.forward_features(tokens, rules)
        wte = self.wte.to(self.cfg.dtype)
        if not is_dtensor(x):
            return lm_logits(x, wte)
        return smap(lm_logits, current_mesh(),
                    in_specs=(spec_for(("batch", "seq", None), rules),
                              spec_for(("vocab", None), rules)),
                    out_specs=spec_for(("batch", "seq", "vocab"), rules))(
            x, wte)

    def loss_fn(self, batch, rules=None):
        """batch: {"tokens": [B, S+1]} -> mean next-token CE. Under a mesh
        each rank takes its (batch, seq) shard against the whole table and
        the sums are psummed over the axes that shard them."""
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        if not is_dtensor(self.wte):
            return cross_entropy_loss(self(inputs), targets)[0]
        x = self.forward_features(inputs, rules)
        x_spec = spec_for(("batch", "seq", None), rules)
        axes = spec_axes(x_spec)

        def body(x, wte, t):
            nll, count = cross_entropy_sums(lm_logits(x, wte), t)
            return psum(nll, axes), psum(count, axes)

        nll, count = smap(body, current_mesh(),
                          in_specs=(x_spec, P(), spec_for(("batch", "seq"),
                                                          rules)),
                          out_specs=(P(), P()))(
            x, self.wte.to(self.cfg.dtype), targets)
        return nll / count.clamp_min(1.0)


def _embed_lookup(wte, tokens, rules):
    """``wte[tokens]``. On a mesh the table is gathered whole and each
    rank looks up its (batch, seq) shard of the indices, as GPT-2's
    ``_embed``."""
    if not is_dtensor(wte):
        return wte[tokens]
    return smap(lambda w, t: w[t], current_mesh(),
                in_specs=(P(), spec_for(("batch", "seq"), rules)),
                out_specs=spec_for(("batch", "seq", None), rules))(
        constrain(wte, (None, None), rules), tokens)


class _Shards:
    """The weights one rank applies in the cache functions: each block's
    local tensors (``blocks``, attribute access as on a ``Block``),
    ``wte`` and ``final_norm``, this rank's head counts (``h``, ``hkv``)
    and first vocab row (``v0``), and under a tp group of ``n`` > 1 ranks
    the ``mesh`` and ``axis`` its sums and gathers run over."""

    def __init__(self, model: "Llama", rules=None):
        cfg = model.cfg
        self.dtype = cfg.dtype
        self.mesh, self.axis, self.n, self.rank = None, None, 1, 0
        if rules is not None and is_dtensor(model.wte):
            self._join(model.wte.device_mesh, rules, cfg)
        n = self.n
        self.h, self.hkv = cfg.num_heads // n, cfg.num_kv_heads // n
        if is_dtensor(model.wte):
            local = lambda p: p.to_local() if is_dtensor(p) else p
            self.blocks = [SimpleNamespace(**{
                k: local(p) for k, p in blk.named_parameters()})
                for blk in model.blocks]
        else:
            local = lambda p: p
            self.blocks = list(model.blocks)
        self.wte, self.final_norm = local(model.wte), local(model.final_norm)
        self.v0 = self.rank * self.wte.shape[0]
        hd, b0 = cfg.head_dim, self.blocks[0]
        want = {"wte": ((cfg.vocab_size // n, cfg.d_model), self.wte.shape),
                "wq": ((cfg.d_model, self.h * hd), b0.wq.shape),
                "wk": ((cfg.d_model, self.hkv * hd), b0.wk.shape),
                "w_down": ((cfg.d_mlp // n, cfg.d_model), b0.w_down.shape)}
        for name, (shape, got) in want.items():
            if tuple(got) != shape:
                raise ValueError(
                    f"{name} holds {tuple(got)} on this rank, not {shape}: "
                    f"the parameters are not placed by the rules "
                    f"(parallel.sharding.place with Llama.logical_axes())")

    def _join(self, mesh, rules, cfg):
        """Take the tp axis from ``rules``: "qkv", "kv", "mlp" and "vocab"
        on one mesh axis, "embed" unsharded, no other axis of the mesh
        larger than one."""
        axes = {rules.get(a) for a in ("qkv", "kv", "mlp", "vocab")}
        sizes = mesh_sizes(mesh)
        axis = next(iter(axes))
        others = [a for a, s in sizes.items() if s > 1 and a != axis]
        if len(axes) != 1 or rules.get("embed") is not None or others:
            raise ValueError(
                "the cache functions shard over one mesh axis: rules must "
                "map qkv, kv, mlp and vocab to it and leave embed unsharded "
                f"(SlotEngine.SERVE_RULES), on a mesh with no other axis; "
                f"got rules {rules} on {sizes}")
        n = 1 if axis is None else sizes.get(axis, 1)
        if n == 1:
            return
        if (cfg.num_kv_heads % n or cfg.num_heads % n or cfg.d_mlp % n
                or cfg.vocab_size % n):
            raise ValueError(
                f"tp={n} must divide num_kv_heads ({cfg.num_kv_heads}), "
                f"num_heads ({cfg.num_heads}), d_mlp ({cfg.d_mlp}) and "
                f"vocab ({cfg.vocab_size})")
        self.mesh, self.axis, self.n = mesh, axis, n
        with use_mesh(mesh):
            self.rank = axis_index(axis)


def _shards(model: "Llama", rules=None) -> _Shards:
    """``_Shards`` of ``model`` under ``rules``; kept on the model while
    its parameters stay the same tensors."""
    if rules is None or not is_dtensor(model.wte):
        return _Shards(model)
    key = (tuple(map(id, model.parameters())), tuple(sorted(rules.items())))
    cached = model.__dict__.get("_shards")
    if cached is None or cached[0] != key:
        cached = model.__dict__["_shards"] = (key, _Shards(model, rules))
    return cached[1]


def _lm_head(x, sh: _Shards):
    """[N, D] hidden states -> [N, vocab] fp32 logits; under tp each rank
    computes its vocab rows and the shards are gathered."""
    x = rms_norm(x, sh.final_norm)
    logits = lm_logits(x, sh.wte.to(sh.dtype))
    if sh.n == 1:
        return logits
    with use_mesh(sh.mesh):
        return all_gather(logits, sh.axis, axis=-1, tiled=True)


def _rot(positions, cfg: LlamaConfig):
    return _rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def _embed(sh: _Shards, tokens):
    """Token embeddings in the model's dtype. Under tp each rank looks up
    the vocab rows it holds (zeros for the others) and the shares are
    summed, which is exact: one term of each sum is not zero."""
    if sh.n == 1:
        return sh.wte[tokens].to(sh.dtype)
    rows = tokens - sh.v0
    mine = (rows >= 0) & (rows < sh.wte.shape[0])
    x = sh.wte[rows.clamp(0, sh.wte.shape[0] - 1)] * mine[..., None]
    return _tp_sum(x.to(sh.dtype), sh)


def _upto(pos, max_seq: int):
    """``arange(max_seq) <= pos``: [..., max_seq] for positions ``pos``
    [...]; callers reshape it to broadcast against [B, Hkv, G, C, S]."""
    return torch.arange(max_seq, device=pos.device) <= pos[..., None]


def _attend(qg, k, v, mask):
    """Grouped-query attention core. qg [B, Hkv, G, C, hd]; k, v
    [B, Hkv, S, hd]; mask broadcastable to [B, Hkv, G, C, S]. Returns
    [B, C, Hkv * G * hd]. Scores are the exact product of the operands
    accumulated in fp32 (16-bit values are exact in fp32, so upcasting the
    view IS the bf16 x bf16 -> fp32 product of the reference, not a bf16
    rounding of the scores)."""
    b, hkv, g, c, hd = qg.shape
    s = k.shape[2]
    scores = torch.matmul(qg.reshape(b, hkv, g * c, hd).float(),
                          k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    scores = torch.where(mask, scores.reshape(b, hkv, g, c, s), _NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.matmul(probs.reshape(b, hkv, g * c, s), v)
    return o.reshape(b, hkv * g, c, hd).transpose(1, 2).reshape(
        b, c, hkv * g * hd)


def _group(q, kv_heads: int):
    b, h, c, hd = q.shape
    return q.reshape(b, kv_heads, h // kv_heads, c, hd)


# ---------------------------------------------------------------------------
# Dense KV cache [L, B, Hkv, max_seq, hd]: the single-request references.
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: LlamaConfig, batch: int, device=None):
    dev = default_device(device)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, cfg.max_seq,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _gqa_cache_attention(q, k_cache, v_cache, mask):
    """q [B, H, C, hd] against k/v [B, Hkv, S, hd]; mask broadcastable to
    [B, Hkv, G, C, S]. Returns [B, C, H * hd]."""
    return _attend(_group(q, k_cache.shape[1]), k_cache, v_cache, mask)


def _cache_layer_step(x, blk: Block, sh: _Shards, rot, kv_mask,
                      write_kv: Callable, attend_view=None):
    """Shared per-layer block of the dense cache paths: they differ only in
    where new K/V lands (``write_kv``, in place) and which cache view
    attention reads (``attend_view``). x [B, T, D] -> x."""
    q, k_new, v_new = _qkv(blk, x, rot, sh.h, sh.hkv)
    k_cache, v_cache = write_kv(k_new, v_new)
    if attend_view is not None:
        k_cache, v_cache = attend_view(k_cache, v_cache)
    o = _gqa_cache_attention(q, k_cache, v_cache, kv_mask)
    return _ffn(blk, _attn_out(blk, x, o))


def _clamp_start(start: int, size: int, total: int) -> int:
    """``dynamic_update_slice``'s start: clamped so the update fits."""
    return max(0, min(start, total - size))


@torch.no_grad()
def decode_step(model: Llama, cache, tokens, pos: int):
    """One decode step: tokens [B] at position ``pos``. Returns (logits
    [B, vocab] fp32, cache)."""
    cfg, sh = model.cfg, _shards(model)
    x = _embed(sh, tokens)[:, None, :]
    positions = torch.full((1,), pos, device=tokens.device)
    kv_mask = _upto(positions, cfg.max_seq)
    rot = _rot(positions, cfg)
    p = _clamp_start(pos, 1, cfg.max_seq)
    for blk, k_cache, v_cache in zip(model.blocks, cache["k"], cache["v"]):
        def write(kn, vn, k_cache=k_cache, v_cache=v_cache):
            k_cache[:, :, p:p + 1] = kn
            v_cache[:, :, p:p + 1] = vn
            return k_cache, v_cache

        x = _cache_layer_step(x, blk, sh, rot, kv_mask, write)
    return _lm_head(x[:, 0], sh), cache


@torch.no_grad()
def decode_slots(model: Llama, cache, tokens, pos):
    """One decode step with PER-SLOT positions: slot b's token is written
    at pos[b] and attends cache positions <= pos[b]. tokens, pos [B].
    Idle slots park at pos = max_seq - 1 (their garbage is overwritten
    before it is attended). Returns (logits [B, vocab] fp32, cache)."""
    cfg, sh = model.cfg, _shards(model)
    x = _embed(sh, tokens)[:, None, :]
    kv_mask = _upto(pos, cfg.max_seq)[:, None, None, None, :]
    rot = _rot(pos[:, None], cfg)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    pw = pos.clamp(0, cfg.max_seq - 1)
    for blk, k_cache, v_cache in zip(model.blocks, cache["k"], cache["v"]):
        def write(kn, vn, k_cache=k_cache, v_cache=v_cache):
            k_cache[rows, :, pw] = kn[:, :, 0]
            v_cache[rows, :, pw] = vn[:, :, 0]
            return k_cache, v_cache

        x = _cache_layer_step(x, blk, sh, rot, kv_mask, write)
    return _lm_head(x[:, 0], sh), cache


@torch.no_grad()
def decode_slots_with_prefill(model: Llama, cache, tokens, pos, pre_tokens,
                              pre_slot: int, pre_p0: int, pre_last_idx: int):
    """Fused step: B decode tokens (one per slot) and one C-token prefill
    chunk for ``pre_slot`` share every weight product as one packed
    [1, B+C, D] sequence; only attention splits. ``pre_slot`` must not be
    an active decode slot. Returns (dec_logits [B, vocab], pre_logits
    [vocab], cache)."""
    cfg, sh = model.cfg, _shards(model)
    b, c, s_max = tokens.shape[0], pre_tokens.shape[0], cfg.max_seq
    x = _embed(sh, torch.cat([tokens, pre_tokens]))[None]
    pre_positions = pre_p0 + torch.arange(c, device=tokens.device)
    rot = _rot(torch.cat([pos, pre_positions])[None], cfg)
    dec_mask = _upto(pos, s_max)[:, None, None, None, :]
    pre_mask = _upto(pre_positions, s_max)[None, None, None]
    rows = torch.arange(b, device=tokens.device)
    pw = pos.clamp(0, s_max - 1)
    p0 = _clamp_start(pre_p0, c, s_max)
    for blk, k_cache, v_cache in zip(model.blocks, cache["k"], cache["v"]):
        q, k_new, v_new = _qkv(blk, x, rot, sh.h, sh.hkv)
        qd = q[0, :, :b].transpose(0, 1)[:, :, None]         # [B,h,1,hd]
        k_cache[rows, :, pw] = k_new[0, :, :b].transpose(0, 1)
        v_cache[rows, :, pw] = v_new[0, :, :b].transpose(0, 1)
        k_cache[pre_slot, :, p0:p0 + c] = k_new[0, :, b:]
        v_cache[pre_slot, :, p0:p0 + c] = v_new[0, :, b:]
        od = _gqa_cache_attention(qd, k_cache, v_cache, dec_mask)
        op = _gqa_cache_attention(
            q[:, :, b:], k_cache[pre_slot:pre_slot + 1],
            v_cache[pre_slot:pre_slot + 1], pre_mask)
        o = torch.cat([od[:, 0][None], op], dim=1)          # [1,B+C,D]
        x = _ffn(blk, _attn_out(blk, x, o))
    heads_in = torch.cat([x[0, :b], x[0, b + pre_last_idx][None]])
    logits = _lm_head(heads_in, sh)
    return logits[:b], logits[b], cache


@torch.no_grad()
def prefill_chunk(model: Llama, cache, tokens, slot: int, p0: int,
                  last_idx: Optional[int] = None):
    """Write one prompt chunk (tokens [C], tail padding allowed) into
    ``slot`` at ``p0`` and return the logits of chunk row ``last_idx``
    ([vocab]) or of every row ([C, vocab]), with the cache."""
    cfg, sh = model.cfg, _shards(model)
    c = tokens.shape[0]
    x = _embed(sh, tokens)[None]
    abs_pos = p0 + torch.arange(c, device=tokens.device)
    kv_mask = _upto(abs_pos, cfg.max_seq)[None, None, None]
    rot = _rot(abs_pos[None], cfg)
    start = _clamp_start(p0, c, cfg.max_seq)
    for blk, k_cache, v_cache in zip(model.blocks, cache["k"], cache["v"]):
        def write(kn, vn, k_cache=k_cache, v_cache=v_cache):
            k_cache[slot:slot + 1, :, start:start + c] = kn
            v_cache[slot:slot + 1, :, start:start + c] = vn
            return k_cache, v_cache

        def view(kc, vc):
            return kc[slot:slot + 1], vc[slot:slot + 1]

        x = _cache_layer_step(x, blk, sh, rot, kv_mask, write, view)
    if last_idx is not None:
        return _lm_head(x[0, last_idx][None], sh)[0], cache
    return _lm_head(x[0], sh), cache


# ---------------------------------------------------------------------------
# Paged KV cache [L, 2, num_pages, page_size, Hkv, hd] (the serving path).
# ---------------------------------------------------------------------------

def init_paged_kv_cache(cfg: LlamaConfig, num_pages: int, page_size: int,
                        device=None, shards: int = 1):
    """The page pool, zeroed: masked positions are gathered and multiplied
    by a probability of exactly 0, which stays 0 only while every cell
    holds a finite value. ``shards`` > 1: one tp rank's pool, with
    num_kv_heads / shards heads."""
    if cfg.max_seq % page_size != 0:
        raise ValueError(
            f"page_size ({page_size}) must divide max_seq ({cfg.max_seq})")
    shape = (cfg.num_layers, 2, num_pages, page_size,
             cfg.num_kv_heads // shards, cfg.head_dim)
    return {"kv": torch.zeros(shape, dtype=cfg.dtype,
                              device=default_device(device))}


def _gather_pages(kv_l, tables):
    """ONE gather: [2, NP, ps, Hkv, hd] by tables [B, P] -> seq-major
    [2, B, P*ps, Hkv, hd]. Logical page l's offset o lands at sequence
    position l * ps + o, so positions and masks are the dense layout's."""
    b, p = tables.shape
    g = kv_l[:, tables]
    return g.reshape(2, b, p * g.shape[3], g.shape[4], g.shape[5])


def _token_dest(tables, rows, pos, page_size: int, max_seq: int):
    """Physical (page, offset) of each row's token at ``pos``: page
    tables[rows, pos // ps] at offset pos % ps; positions >= max_seq
    (parked rows, overshoot) go to the scratch page 0, offset 0."""
    valid = pos < max_seq
    lpage = torch.clamp_max(pos // page_size, tables.shape[1] - 1)
    phys = torch.where(valid, tables[rows, lpage], 0)
    off = torch.where(valid, pos % page_size, 0)
    return phys, off


def _scatter_token_kv(kv_l, kn, vn, dest):
    """One scatter of K and V, [N, Hkv, hd] each, to ``dest`` =
    (phys, off) from :func:`_token_dest`, in place. Several rows may land
    on the scratch cell (0, 0); whichever wins, that cell is only ever
    read under a zero weight."""
    phys, off = dest
    kv_l[:, phys, off] = torch.stack([kn, vn])
    return kv_l


def _gqa_paged_attention(q, kv, mask):
    """q [B, H, C, hd] against a gathered seq-major view kv [2, B, S, Hkv,
    hd]; mask broadcastable to [B, Hkv, G, C, S]. Returns [B, C, H * hd]."""
    return _attend(_group(q, kv.shape[3]), kv[0].transpose(1, 2),
                   kv[1].transpose(1, 2), mask)


def _paged_layer_step(x, w, sh: _Shards, rot, kv_mask, write_kv: Callable,
                      attend_view: Callable):
    """The paged twin of :func:`_cache_layer_step`, on one rank's shards
    ``w`` of a layer: ``write_kv`` lands new K/V by physical page id (in
    place), ``attend_view`` gathers the seq-major view attention reads.
    x [B, T, D] -> x."""
    q, k_new, v_new = _qkv(w, x, rot, sh.h, sh.hkv)
    kv_l = write_kv(k_new, v_new)
    o = _gqa_paged_attention(q, attend_view(kv_l), kv_mask)
    return _ffn(w, _attn_out(w, x, o, sh), sh)


def _paged_shards(model: Llama, cache, rules) -> _Shards:
    """``_shards`` of the model, checked against the page pool's
    heads."""
    sh = _shards(model, rules)
    if cache["kv"].shape[4] != sh.hkv:
        raise ValueError(
            f"the page pool holds {cache['kv'].shape[4]} KV heads; this "
            f"rank's shards hold {sh.hkv} (init_paged_kv_cache(shards=))")
    return sh


@torch.no_grad()
def decode_slots_paged(model: Llama, cache, tables, tokens, pos,
                       page_size: int, rules=None):
    """``decode_slots`` over the paged cache. tables [B, P], tokens [B],
    pos [B]. Parked rows (pos >= max_seq) write only into the scratch
    page. Returns (logits [B, vocab] fp32, cache)."""
    cfg, sh = model.cfg, _paged_shards(model, cache, rules)
    x = _embed(sh, tokens)[:, None, :]
    kv_mask = _upto(pos, cfg.max_seq)[:, None, None, None, :]
    rot = _rot(pos[:, None], cfg)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    dest = _token_dest(tables, rows, pos, page_size, cfg.max_seq)
    for w, kv_l in zip(sh.blocks, cache["kv"]):
        def write(kn, vn, kv_l=kv_l):
            return _scatter_token_kv(kv_l, kn[:, :, 0], vn[:, :, 0], dest)

        x = _paged_layer_step(x, w, sh, rot, kv_mask, write,
                              lambda kv: _gather_pages(kv, tables))
    return _lm_head(x[:, 0], sh), cache


def _row(t, i):
    """``t[i]`` for an int or a one-element index tensor (no host
    sync)."""
    if isinstance(i, int):
        return t[i]
    return t.index_select(0, i.reshape(1).long())[0]


def _chunk_dest(tables, slot, abs_pos, n_valid, page_size: int,
                max_seq: int):
    """Destinations of a chunk's tokens in ``slot``'s pages; rows at index
    >= n_valid (tail padding) and past max_seq go to the scratch page."""
    idx = torch.arange(abs_pos.shape[0], device=abs_pos.device)
    valid = (idx < n_valid) & (abs_pos < max_seq)
    lpage = torch.clamp_max(abs_pos // page_size, tables.shape[1] - 1)
    phys = torch.where(valid, _row(tables, slot)[lpage], 0)
    off = torch.where(valid, abs_pos % page_size, 0)
    return phys, off


@torch.no_grad()
def prefill_chunk_paged(model: Llama, cache, tables, tokens, slot, p0,
                        n_valid, page_size: int, rules=None):
    """``prefill_chunk`` over the paged cache: tokens [C] (tail padding
    allowed) into ``slot``'s pages from position p0, each token to its own
    page (a chunk may straddle pages). Returns ([vocab] logits of chunk
    row n_valid - 1, cache)."""
    cfg, sh = model.cfg, _paged_shards(model, cache, rules)
    x = _embed(sh, tokens)[None]
    abs_pos = p0 + torch.arange(tokens.shape[0], device=tokens.device)
    kv_mask = _upto(abs_pos, cfg.max_seq)[None, None, None]
    rot = _rot(abs_pos[None], cfg)
    dest = _chunk_dest(tables, slot, abs_pos, n_valid, page_size, cfg.max_seq)
    slot_table = _row(tables, slot)[None]
    for w, kv_l in zip(sh.blocks, cache["kv"]):
        def write(kn, vn, kv_l=kv_l):
            return _scatter_token_kv(kv_l, kn[0].transpose(0, 1),
                                     vn[0].transpose(0, 1), dest)

        x = _paged_layer_step(x, w, sh, rot, kv_mask, write,
                              lambda kv: _gather_pages(kv, slot_table))
    return _lm_head(_row(x[0], n_valid - 1)[None], sh)[0], cache


@torch.no_grad()
def decode_slots_with_prefill_paged(model: Llama, cache, tables, tokens, pos,
                                    pre_tokens, pre_slot, pre_p0,
                                    pre_n_valid, page_size: int, rules=None):
    """Fused step over the paged cache: B decode tokens and one C-token
    prefill chunk share every weight product; decode rows scatter one
    token each, the chunk scatters into ``pre_slot``'s pages, invalid
    writes go to the scratch page. ``pre_slot`` must not be an active
    decode row, so the two scatters touch disjoint pages; both land
    before attention, so in-chunk causality holds. Returns (dec_logits
    [B, vocab], pre_logits [vocab], cache)."""
    cfg, sh = model.cfg, _paged_shards(model, cache, rules)
    b, c, s_max = tokens.shape[0], pre_tokens.shape[0], cfg.max_seq
    x = _embed(sh, torch.cat([tokens, pre_tokens]))[None]
    pre_positions = pre_p0 + torch.arange(c, device=tokens.device)
    rot = _rot(torch.cat([pos, pre_positions])[None], cfg)
    dec_mask = _upto(pos, s_max)[:, None, None, None, :]
    pre_mask = _upto(pre_positions, s_max)[None, None, None]
    rows = torch.arange(b, device=tokens.device)
    dec_dest = _token_dest(tables, rows, pos, page_size, s_max)
    pre_dest = _chunk_dest(tables, pre_slot, pre_positions, pre_n_valid,
                           page_size, s_max)
    slot_table = _row(tables, pre_slot)[None]
    for w, kv_l in zip(sh.blocks, cache["kv"]):
        q, k_new, v_new = _qkv(w, x, rot, sh.h, sh.hkv)
        k_new, v_new = k_new[0].transpose(0, 1), v_new[0].transpose(0, 1)
        _scatter_token_kv(kv_l, k_new[:b], v_new[:b], dec_dest)
        _scatter_token_kv(kv_l, k_new[b:], v_new[b:], pre_dest)
        od = _gqa_paged_attention(q[0, :, :b].transpose(0, 1)[:, :, None],
                                  _gather_pages(kv_l, tables), dec_mask)
        op = _gqa_paged_attention(q[:, :, b:],
                                  _gather_pages(kv_l, slot_table), pre_mask)
        o = torch.cat([od[:, 0][None], op], dim=1)          # [1,B+C,D]
        x = _ffn(w, _attn_out(w, x, o, sh), sh)
    heads_in = torch.cat([x[0, :b], _row(x[0], b + pre_n_valid - 1)[None]])
    logits = _lm_head(heads_in, sh)
    return logits[:b], logits[b], cache


@torch.no_grad()
def copy_pages(cache, src, dst):
    """Page copy (the COW of copy-on-write): physical pages src[i] ->
    dst[i] across every layer, in place."""
    kv = cache["kv"]
    kv[:, :, torch.as_tensor(dst, device=kv.device)] = \
        kv[:, :, torch.as_tensor(src, device=kv.device)]
    return cache


@torch.no_grad()
def write_pages(cache, dst, values):
    """Page import (session migration): physical pages dst[i] <-
    values[:, :, i] across every layer, in place. values [L, 2, N,
    page_size, Hkv, hd], any float dtype (cast to the cache's)."""
    kv = cache["kv"]
    kv[:, :, torch.as_tensor(dst, device=kv.device)] = values.to(
        device=kv.device, dtype=kv.dtype)
    return cache


@torch.no_grad()
def generate(model: Llama, prompt_tokens, max_new: int = 32,
             temperature: float = 0.0, key=None):
    """Greedy or sampled generation over the dense cache, one decode_step
    per prompt token (the reference the engine is held against).
    ``key`` is a ``ray_tpu_torch.random.prng_key``; sampled tokens follow
    ``jax.random.split`` and ``categorical`` as the JAX package draws
    them."""
    if temperature > 0 and key is None:
        raise ValueError("temperature > 0 requires a PRNG key")
    b, s = prompt_tokens.shape
    cache = init_kv_cache(model.cfg, b, prompt_tokens.device)
    logits = None
    for i in range(s):
        logits, cache = decode_step(model, cache, prompt_tokens[:, i], i)
    out = [prompt_tokens]
    for j in range(max_new):
        if temperature > 0:
            k0, k1 = trandom.split(key)
            key, sub = (k0[0], k1[0]), (k0[1], k1[1])
            cur = trandom.categorical(sub, logits / temperature)
        else:
            cur = torch.argmax(logits, dim=-1)
        cur = cur.to(prompt_tokens.dtype)
        out.append(cur[:, None])
        logits, cache = decode_step(model, cache, cur, s + j)
    return torch.cat(out, dim=1)
