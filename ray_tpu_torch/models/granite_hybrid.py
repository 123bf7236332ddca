"""Granite 4.0-H: a hybrid decoder of Mamba-2 state-space layers and NoPE
grouped-query attention, with a dropless top-k mixture of experts and a
shared expert on every layer.

The equations are those of ``transformers``' ``granitemoehybrid`` modeling
code (``GraniteMoeHybridForCausalLM`` and its parts):

- the token embedding times ``embedding_multiplier``; then each layer of
  ``layer_types``: ``x += mixer(rms_norm(x)) * residual_multiplier``, the
  mixer a Mamba-2 mixer or attention, then ``x += (moe(h) + shared(h)) *
  residual_multiplier`` with ``h = rms_norm(x)``; a final RMSNorm; the tied
  head's logits divided by ``logits_scaling``; mean next-token
  cross-entropy plus ``router_aux_loss_coef`` times the load-balancing
  loss (Switch Transformer's, over every layer's router at once:
  experts times the sum over experts of the share of (token, choice)
  pairs routed there and the mean router probability);
- the Mamba-2 mixer: ``in_proj`` to z, xBC and dt; a causal depthwise
  conv of width ``mamba_d_conv`` with bias over xBC, then SiLU, split into
  x, B and C; ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the
  SSD scan (``ops.ssd``) plus the skip ``D x``; the gated RMSNorm
  ``rms_norm(y * silu(z))``; ``out_proj``;
- attention: q, k, v projections without bias, no rotation
  (``position_embedding_type`` "nope"), query head h reading KV head
  h // (heads / KV heads), causal, scores scaled by
  ``attention_multiplier``; the output projection. It runs through
  ``ops.attention.attention`` (on a card the flash kernels);
- the experts: a router over all ``num_local_experts`` without bias, top
  ``num_experts_per_tok`` weighted by the softmax over the chosen logits,
  each expert a SwiGLU of width ``intermediate_size``
  (``parallel.moe.moe_dropless``, on the experts ``experts_held``); the
  shared expert a SwiGLU of width ``shared_intermediate_size``.

Departures, none of them in the equations:

- weights are ``[in, out]`` matrices applied as ``y @ w`` (the source's
  ``nn.Linear`` holds ``[out, in]``), the conv's ``[channels, width]``, the
  experts' ``[experts, in, out]``;
- ``dt``'s softplus, the scan, the skip and the gated norm are fp32; the
  source rounds ``dt`` to the activations' type first and multiplies the
  norms' weights in that type;
- the routed experts' weighted outputs are summed in fp32 (the source
  sums in the activations' type);
- a model may hold a share of the experts (``experts_held``, expert
  parallelism's share): the router still picks among all of them and
  only the held experts' part of the routed output is computed;
- the head's input is multiplied by 1 / ``logits_scaling`` before the
  tied product, which is the source's division of the logits exactly when
  ``logits_scaling`` is a power of two (16 in the published config);
- the head and the loss run in token chunks (``chunked_cross_entropy``)
  and, while gradients are taken, each layer is recomputed in the
  backward.

Parameters are named ``layers.<i>.<...>`` so that each is an optimizer
leaf of its own. Each layer is a device span ``granite.layer``, and within
it each call of the scan and of the experts (``ssm.*``, ``moe.*``); a
layer recomputed on autograd's thread joins the trace the forward ran
in.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import default_device
from ..observability import tracing
from ..ops.attention import attention
from ..ops.ssd import ssd
from ..parallel.moe import moe_dropless
from .common import chunked_cross_entropy, expand_kv_heads, rms_norm

# Tokens a chunk of the head and the loss (``chunked_cross_entropy``).
LOSS_CHUNK = 4096
PUBLISHED_LAYER_TYPES = tuple(
    "attention" if i in (5, 15, 25, 35) else "mamba" for i in range(40))


@dataclass
class GraniteHybridConfig:
    """The published ``config.json`` keys (granite-4.0-h-small's values by
    default), then the port's own: the experts held and the parameters'
    type."""
    vocab_size: int = 100352
    hidden_size: int = 4096
    num_hidden_layers: int = 40
    layer_types: Tuple[str, ...] = PUBLISHED_LAYER_TYPES
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    attention_multiplier: float = 0.0078125
    attention_bias: bool = False
    position_embedding_type: str = "nope"
    mamba_n_heads: int = 128
    mamba_d_head: int = 64
    mamba_d_state: int = 128
    mamba_n_groups: int = 1
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk_size: int = 256
    mamba_conv_bias: bool = True
    mamba_proj_bias: bool = False
    num_local_experts: int = 72
    num_experts_per_tok: int = 10
    intermediate_size: int = 768
    shared_intermediate_size: int = 1536
    hidden_act: str = "silu"
    embedding_multiplier: float = 12.0
    residual_multiplier: float = 0.22
    logits_scaling: float = 16.0
    rms_norm_eps: float = 1e-5
    router_aux_loss_coef: float = 0.001
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    # (first, count) of the experts this model holds; None: all of them.
    experts_held: Optional[Tuple[int, int]] = None
    dtype: torch.dtype = torch.float32

    @classmethod
    def from_dict(cls, conf: Dict, **port) -> "GraniteHybridConfig":
        """The fields of ``conf`` (a ``config.json``'s keys) that this
        config has, then ``port``."""
        names = {f.name for f in fields(cls)}
        kw = {k: v for k, v in conf.items() if k in names}
        kw["layer_types"] = tuple(kw.get("layer_types",
                                         PUBLISHED_LAYER_TYPES))
        return cls(**{**kw, **port})

    @property
    def held(self) -> Tuple[int, int]:
        return self.experts_held or (0, self.num_local_experts)

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def _check_supported(cfg: GraniteHybridConfig) -> None:
    wanted = {"mamba_n_groups": 1, "mamba_proj_bias": False,
              "attention_bias": False, "position_embedding_type": "nope",
              "hidden_act": "silu", "tie_word_embeddings": True}
    for key, value in wanted.items():
        if getattr(cfg, key) != value:
            raise ValueError(f"{key}={getattr(cfg, key)!r}: only {value!r} "
                             f"is supported")
    if len(cfg.layer_types) != cfg.num_hidden_layers or not set(
            cfg.layer_types) <= {"mamba", "attention"}:
        raise ValueError(f"layer_types {cfg.layer_types} for "
                         f"{cfg.num_hidden_layers} layers")
    if cfg.d_inner != cfg.mamba_n_heads * cfg.mamba_d_head:
        raise ValueError("mamba_expand * hidden_size must equal "
                         "mamba_n_heads * mamba_d_head")


class _Init:
    """Parameters of one type on one device: normals of the configured
    std drawn in fp32 from ``generator`` (the device's default generator
    when None), and constants."""

    def __init__(self, cfg: GraniteHybridConfig, generator, device):
        self.cfg, self.gen, self.dev = cfg, generator, device

    def normal(self, *shape) -> nn.Parameter:
        t = torch.empty(shape, device=self.dev).normal_(
            0.0, self.cfg.initializer_range, generator=self.gen)
        return nn.Parameter(t.to(self.cfg.dtype))

    def const(self, t: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(t.to(self.dev, self.cfg.dtype))


class MambaMixer(nn.Module):
    """The Mamba-2 mixer: ``in_proj`` [d, d_inner + conv + heads], the
    depthwise conv ``conv_w`` [conv, width] and ``conv_b``, ``dt_bias``,
    ``A_log``, ``D`` [heads], the gated norm's ``norm`` [d_inner],
    ``out_proj`` [d_inner, d]; conv = d_inner + 2 d_state."""

    def __init__(self, cfg: GraniteHybridConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        d, di, h = cfg.hidden_size, cfg.d_inner, cfg.mamba_n_heads
        conv = di + 2 * cfg.mamba_d_state
        self.in_proj = init.normal(d, di + conv + h)
        self.conv_w = init.normal(conv, cfg.mamba_d_conv)
        self.conv_b = init.const(torch.zeros(conv))
        self.dt_bias = init.const(torch.ones(h))
        self.A_log = init.const(torch.log(torch.arange(1, h + 1,
                                                       dtype=torch.float32)))
        self.D = init.const(torch.ones(h))
        self.norm = init.const(torch.ones(di))
        self.out_proj = init.normal(di, d)

    def forward(self, h):
        cfg = self.cfg
        s = h.shape[1]
        di, n, heads = cfg.d_inner, cfg.mamba_d_state, cfg.mamba_n_heads
        z, xbc, dt = (h @ self.in_proj).split([di, di + 2 * n, heads], -1)
        xbc = F.conv1d(xbc.transpose(1, 2), self.conv_w[:, None], self.conv_b,
                       padding=cfg.mamba_d_conv - 1, groups=xbc.shape[-1])
        # Position-major, so that a position's x, B and C are rows (the
        # scan's kernels read them so).
        x, B, C = F.silu(xbc[..., :s].transpose(1, 2)).contiguous().split(
            [di, n, n], -1)
        x = x.unflatten(-1, (heads, cfg.mamba_d_head))
        dt = F.softplus(dt.float() + self.dt_bias.float())
        A = -torch.exp(self.A_log.float())
        y = ssd(x, dt, A, B, C, cfg.mamba_chunk_size)
        y = y + self.D.float()[:, None] * x.float()
        y = rms_norm(y.flatten(2) * F.silu(z.float()), self.norm,
                     cfg.rms_norm_eps)
        return y.to(h.dtype) @ self.out_proj


class Attention(nn.Module):
    """Grouped-query attention without rotation: ``wq`` [d, heads * hd],
    ``wk``, ``wv`` [d, kv heads * hd], ``wo`` [heads * hd, d]."""

    def __init__(self, cfg: GraniteHybridConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.hidden_size, cfg.head_dim
        self.wq = init.normal(d, cfg.num_attention_heads * hd)
        self.wk = init.normal(d, cfg.num_key_value_heads * hd)
        self.wv = init.normal(d, cfg.num_key_value_heads * hd)
        self.wo = init.normal(cfg.num_attention_heads * hd, d)

    def forward(self, h):
        cfg = self.cfg
        b, s, _ = h.shape
        heads, kv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                         cfg.head_dim)
        q = (h @ self.wq).view(b, s, heads, hd).transpose(1, 2)
        k = (h @ self.wk).view(b, s, kv, hd).transpose(1, 2)
        v = (h @ self.wv).view(b, s, kv, hd).transpose(1, 2)
        k, v = expand_kv_heads(k, v, heads, heads // kv)
        o = attention(q.contiguous(), k, v, causal=True,
                      scale=cfg.attention_multiplier)
        return o.transpose(1, 2).reshape(b, s, heads * hd) @ self.wo


class Experts(nn.Module):
    """The routed experts this model holds and the shared expert:
    ``router`` [d, experts], ``experts_in`` [held, d, 2 m], ``experts_out``
    [held, m, d], ``shared_in`` [d, 2 ms], ``shared_out`` [ms, d]."""

    def __init__(self, cfg: GraniteHybridConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        d, m, ms = (cfg.hidden_size, cfg.intermediate_size,
                    cfg.shared_intermediate_size)
        held = cfg.held[1]
        self.router = init.normal(d, cfg.num_local_experts)
        self.experts_in = init.normal(held, d, 2 * m)
        self.experts_out = init.normal(held, m, d)
        self.shared_in = init.normal(d, 2 * ms)
        self.shared_out = init.normal(ms, d)

    def forward(self, h):
        """(routed + shared output, the mean router probabilities [E], the
        pairs routed to each expert [E])."""
        cfg = self.cfg
        routed, probs, counts = moe_dropless(
            h.reshape(-1, h.shape[-1]), self.router, self.experts_in,
            self.experts_out, num_experts=cfg.num_local_experts,
            top_k=cfg.num_experts_per_tok, experts_held=cfg.held)
        gate, up = (h @ self.shared_in).chunk(2, dim=-1)
        shared = (F.silu(gate) * up) @ self.shared_out
        return routed.view_as(h) + shared, probs.mean(0), counts


class Layer(nn.Module):
    """One decoder layer: ``input_norm``, the mixer (``mamba`` or
    ``attn``), ``post_norm``, ``moe``."""

    def __init__(self, cfg: GraniteHybridConfig, kind: str, init: _Init):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        d = cfg.hidden_size
        self.input_norm = init.const(torch.ones(d))
        if kind == "mamba":
            self.mamba = MambaMixer(cfg, init)
        else:
            self.attn = Attention(cfg, init)
        self.post_norm = init.const(torch.ones(d))
        self.moe = Experts(cfg, init)

    def forward(self, x):
        cfg = self.cfg
        mixer = self.mamba if self.kind == "mamba" else self.attn
        h = rms_norm(x, self.input_norm, cfg.rms_norm_eps)
        x = x + mixer(h) * cfg.residual_multiplier
        out, pmean, counts = self.moe(
            rms_norm(x, self.post_norm, cfg.rms_norm_eps))
        return x + out * cfg.residual_multiplier, pmean, counts


def _traced_layer(layer: Layer, x, trace: Optional[str]):
    """``layer(x)`` in a device span ``granite.layer`` of ``trace`` (the
    forward's, so that a recompute on autograd's thread joins it); the
    spans opened within nest under it."""
    with tracing.device_span("granite.layer", x, trace):
        return layer(x)


class GraniteHybrid(nn.Module):
    """The language model: ``embed`` [vocab, d] (the tied head too),
    ``layers``, ``final_norm``. Parameters are created in ``cfg.dtype`` on
    ``device`` (``cuda`` unless the caller asks for the CPU), drawn from
    ``generator`` (which must live on that device) or that device's
    default generator: normals of std ``initializer_range``, norms and
    ``D`` at 1, ``dt_bias`` at 1, ``A_log = log(1..heads)``, the conv's bias
    at 0, as the source's ``_init_weights``."""

    def __init__(self, cfg: GraniteHybridConfig,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        init = _Init(cfg, generator, default_device(device))
        self.embed = init.normal(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(Layer(cfg, kind, init)
                                    for kind in cfg.layer_types)
        self.final_norm = init.const(torch.ones(cfg.hidden_size))

    def forward_features(self, tokens):
        """tokens [B, S] -> (final-normed hidden states [B, S, d], the
        load-balancing loss). While gradients are taken each layer is
        recomputed in the backward."""
        cfg = self.cfg
        x = F.embedding(tokens, self.embed) * cfg.embedding_multiplier
        span = tracing.current_span()
        trace = None if span is None else span.trace_id
        pmeans, counts = [], []
        for layer in self.layers:
            if torch.is_grad_enabled():
                x, pm, c = checkpoint(_traced_layer, layer, x, trace,
                                      use_reentrant=False)
            else:
                x, pm, c = _traced_layer(layer, x, trace)
            pmeans.append(pm)
            counts.append(c)
        share = torch.stack(counts).sum(0).float() / (
            len(counts) * tokens.numel())
        aux = cfg.num_local_experts * (share * torch.stack(pmeans).mean(0)
                                       ).sum()
        return rms_norm(x, self.final_norm, cfg.rms_norm_eps), aux

    def loss_fn(self, batch):
        """batch: {"tokens": [B, S + 1]} -> mean next-token cross-entropy
        plus ``router_aux_loss_coef`` times the load-balancing loss."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x, aux = self.forward_features(tokens[:, :-1])
        nll, count = chunked_cross_entropy(
            x * (1.0 / cfg.logits_scaling), self.embed, tokens[:, 1:],
            LOSS_CHUNK)
        return nll / count.clamp_min(1.0) + cfg.router_aux_loss_coef * aux

