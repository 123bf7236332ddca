"""GPT-2 family, dense path: counterpart of the JAX package's
``models/gpt2.py``.

Learned positional embeddings, pre-LN blocks with fused QKV, causal flash
attention (the port's CUDA kernels on the card), tanh-GELU MLP, and the
tied LM head with fp32 logits and a chunked cross-entropy. Parameters keep
the JAX package's names and layouts (``qkv_w`` is ``[d, 3d]``, applied as
``y @ w``), one ``Block`` per layer where JAX stacks them ``[L, ...]``;
``convert.py`` carries a JAX pytree across.

Activations run in ``cfg.dtype`` (bf16); layer norms, logits and the loss
in fp32. Not ported yet, and refused with ``NotImplementedError``: the
sequence-parallel attention impls, MoE, sharding rules and pp (ROADMAP
Queue A item 7).

Remat (``remat_policy``) keeps the saved set of the JAX package's policy
of the same name and recomputes the rest of the block in the backward,
on ``torch.utils.checkpoint``. A block is five parts, each named for the
tensor it makes (the JAX package's ``checkpoint_name`` tags):

  qkv      ln1 and the fused QKV product
  attn     heads, flash attention (K1) -> ``attn_out`` and ``attn_lse``
  proj     the output projection plus the residual
  mlp_in   ln2 and the first MLP product
  mlp_out  tanh-GELU and the second MLP product

A policy keeps the outputs of some parts (``REMAT_KEEPS``). The block is
cut after each kept part; each run of parts between cuts is one
checkpointed region, whose inputs are all it holds for the backward, so
what a region keeps is visible to ``saved_tensors_hooks``. A kept
attention runs outside any region: its autograd node holds q, k, v (the
``qkv`` tag, in head layout), o and lse, and K1 is not run again in the
backward. In a recompute, the last part of a region skips its product:
its output is read by no backward, as XLA drops it from the JAX
package's recompute.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention as attention_op
from .common import (cross_entropy_sums, layer_norm, lm_logits,
                     truncated_normal)


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304  # padded to 128 multiple (50257 -> 50304)
    max_seq: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_mlp: Optional[int] = None
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "auto"  # auto|flash|reference (ring|ulysses: A7)
    # none|full|dots|dots_attn|mem|mem2 (REMAT_KEEPS). The JAX package's
    # default is "dots", and its remat=False reads as "none" here.
    remat_policy: str = "none"
    num_experts: int = 0

    @property
    def mlp_dim(self) -> int:
        return self.d_mlp or 4 * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def num_params(self) -> int:
        wpe = self.max_seq * self.d_model
        wte = self.vocab_size * self.d_model
        per_layer = (
            4 * self.d_model * self.d_model  # qkv + proj
            + 2 * self.d_model * self.mlp_dim  # mlp in/out
            + 2 * self.d_model * 2  # lns
            + 4 * self.d_model + self.mlp_dim + self.d_model  # biases(ish)
        )
        return wte + wpe + self.num_layers * per_layer + 2 * self.d_model


# Published GPT-2 sizes (vocab padded for lane alignment).
CONFIGS: Dict[str, GPT2Config] = {
    "gpt2-124m": GPT2Config(num_layers=12, num_heads=12, d_model=768),
    "gpt2-355m": GPT2Config(num_layers=24, num_heads=16, d_model=1024),
    "gpt2-774m": GPT2Config(num_layers=36, num_heads=20, d_model=1280),
    "gpt2-1.5b": GPT2Config(num_layers=48, num_heads=25, d_model=1600),
}


def _check_supported(cfg: GPT2Config) -> None:
    if cfg.attention_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r} needs sequence "
            "parallelism: ROADMAP Queue A item 7 (parallel/ on "
            "torch.distributed)")
    if cfg.num_experts > 0:
        raise NotImplementedError(
            "MoE blocks need expert parallelism: ROADMAP Queue A item 7")
    if cfg.remat_policy != "none" and cfg.remat_policy not in REMAT_KEEPS:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; one "
                         f"of none, {', '.join(REMAT_KEEPS)}")


# The parts of a block in order, with the earlier outputs each one reads
# ("x" is the block's input). The block returns proj + mlp_out.
_READS = {"qkv": ("x",), "attn": ("qkv",), "proj": ("x", "attn"),
          "mlp_in": ("proj",), "mlp_out": ("mlp_in",)}
_PART_NAMES = tuple(_READS)

# Parts whose outputs each policy keeps for the backward; the rest is
# recomputed. As ``ray_tpu/models/gpt2.py`` forward_features: "dots" keeps
# the weight products (``dots_with_no_batch_dims_saveable``: not
# attention), "dots_attn" those and attention, "mem" qkv, attention and
# mlp_in, "mem2" qkv and attention, "full" nothing. Keeping mlp_out, the
# last part, changes nothing: no backward reads it.
REMAT_KEEPS: Dict[str, frozenset] = {
    "full": frozenset(),
    "dots": frozenset({"qkv", "proj", "mlp_in", "mlp_out"}),
    "dots_attn": frozenset({"qkv", "attn", "proj", "mlp_in", "mlp_out"}),
    "mem": frozenset({"qkv", "attn", "mlp_in"}),
    "mem2": frozenset({"qkv", "attn"}),
}


def _regions(keep: frozenset):
    """The runs of parts between cuts: a cut follows each kept part."""
    runs, run = [], []
    for name in _PART_NAMES:
        run.append(name)
        if name in keep or name == _PART_NAMES[-1]:
            runs.append(tuple(run))
            run = []
    return runs


def _inputs(run):
    """The tensors parts ``run`` read from before the run, in order."""
    out = []
    for name in run:
        for i in _READS[name]:
            if i not in run and i not in out:
                out.append(i)
    return out


class _Recompute:
    """Whether one checkpointed region is running its recompute, for
    ``checkpoint(context_fn=...)``."""

    def __init__(self):
        self.active = False

    def contexts(self):
        return contextlib.nullcontext(), self._recomputing()

    @contextlib.contextmanager
    def _recomputing(self):
        self.active = True
        try:
            yield
        finally:
            self.active = False


class _Dense(torch.autograd.Function):
    """``y @ w + b`` inside a checkpointed region. Saves y and w; with
    ``skip`` (a region's last product, in its recompute) the output is
    left uncomputed, since no backward reads it."""

    @staticmethod
    def forward(ctx, y, w, b, skip: bool):
        ctx.save_for_backward(y, w)
        if skip:
            return y.new_empty(y.shape[:-1] + w.shape[1:])
        return F.linear(y, w.t(), b)

    @staticmethod
    def backward(ctx, g):
        y, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dw = y.reshape(-1, y.shape[-1]).t() @ g2
        return g @ w.t(), dw, g2.sum(0), None


class Block(nn.Module):
    """One pre-LN transformer block (``_block`` in the JAX package)."""

    def __init__(self, cfg: GPT2Config, generator=None):
        super().__init__()
        self.cfg = cfg
        d, m = cfg.d_model, cfg.mlp_dim
        proj_std = 0.02 / math.sqrt(2 * cfg.num_layers)
        tn = lambda shape, std=0.02: nn.Parameter(
            truncated_normal(shape, generator, stddev=std))
        self.ln1_scale = nn.Parameter(torch.ones(d))
        self.ln1_bias = nn.Parameter(torch.zeros(d))
        self.qkv_w = tn((d, 3 * d))
        self.qkv_b = nn.Parameter(torch.zeros(3 * d))
        self.proj_w = tn((d, d), proj_std)
        self.proj_b = nn.Parameter(torch.zeros(d))
        self.ln2_scale = nn.Parameter(torch.ones(d))
        self.ln2_bias = nn.Parameter(torch.zeros(d))
        self.mlp_in_w = tn((d, m))
        self.mlp_in_b = nn.Parameter(torch.zeros(m))
        self.mlp_out_w = tn((m, d), proj_std)
        self.mlp_out_b = nn.Parameter(torch.zeros(d))

    @staticmethod
    def _dense(y, w, b, skip: Optional[bool]):
        """``y @ w + b`` in y's dtype; ``skip`` None outside a region."""
        w, b = w.to(y.dtype), b.to(y.dtype)
        if skip is None:
            return F.linear(y, w.t(), b)
        return _Dense.apply(y, w, b, skip)

    def _part(self, name: str, inputs, skip: Optional[bool]):
        if name == "qkv":
            (x,) = inputs
            y = layer_norm(x, self.ln1_scale, self.ln1_bias)
            return self._dense(y, self.qkv_w, self.qkv_b, skip)
        if name == "attn":
            (qkv,) = inputs
            b, s, _ = qkv.shape
            h, hd = self.cfg.num_heads, self.cfg.head_dim
            # [B,S,D] -> [B,H,S,hd], contiguous for the kernels
            q, k, v = (t.reshape(b, s, h, hd).transpose(1, 2).contiguous()
                       for t in qkv.split(h * hd, dim=-1))
            return attention_op(q, k, v, causal=True,
                                impl=self.cfg.attention_impl)
        if name == "proj":
            x, o = inputs
            o = o.transpose(1, 2).reshape(x.shape)
            return x + self._dense(o, self.proj_w, self.proj_b, skip)
        if name == "mlp_in":
            (x,) = inputs
            y = layer_norm(x, self.ln2_scale, self.ln2_bias)
            return self._dense(y, self.mlp_in_w, self.mlp_in_b, skip)
        (hdn,) = inputs
        hdn = F.gelu(hdn, approximate="tanh")
        return self._dense(hdn, self.mlp_out_w, self.mlp_out_b, skip)

    def _run(self, run, outputs, rc: Optional[_Recompute], *tensors):
        """Parts ``run`` from their inputs (``tensors``, named as
        ``_inputs(run)``); returns the named ``outputs``. Under ``rc`` the
        run is a checkpointed region and its last product is skipped in
        the recompute."""
        env = dict(zip(_inputs(run), tensors))
        for name in run:
            skip = None if rc is None else (rc.active and name == run[-1])
            env[name] = self._part(name, [env[i] for i in _READS[name]],
                                   skip)
        return tuple(env[n] for n in outputs)

    def forward(self, x):
        policy = self.cfg.remat_policy
        runs = ([_PART_NAMES] if policy == "none"
                else _regions(REMAT_KEEPS[policy]))
        env = {"x": x}
        for i, run in enumerate(runs):
            later = {r for nxt in runs[i + 1:] for n in nxt for r in _READS[n]}
            outputs = tuple(n for n in run if n in later | {"proj", "mlp_out"})
            ins = [env[n] for n in _inputs(run)]
            if policy == "none" or run == ("attn",):
                # No remat, or a kept attention: _Flash's node holds q, k,
                # v, o and lse.
                outs = self._run(run, outputs, None, *ins)
            else:
                rc = _Recompute()
                outs = checkpoint(self._run, run, outputs, rc, *ins,
                                  use_reentrant=False,
                                  context_fn=rc.contexts)
            env.update(zip(outputs, outs))
        return env["proj"] + env["mlp_out"]


class GPT2(nn.Module):
    """GPT-2 LM. Parameters are created fp32 on the CPU from ``generator``
    (move the module with ``.to(device)``)."""

    def __init__(self, cfg: GPT2Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        d = cfg.d_model
        self.wte = nn.Parameter(
            truncated_normal((cfg.vocab_size, d), generator))
        self.wpe = nn.Parameter(
            truncated_normal((cfg.max_seq, d), generator, stddev=0.01))
        self.blocks = nn.ModuleList(Block(cfg, generator)
                                    for _ in range(cfg.num_layers))
        self.lnf_scale = nn.Parameter(torch.ones(d))
        self.lnf_bias = nn.Parameter(torch.zeros(d))

    def forward_features(self, tokens, rules=None):
        """tokens [B, S] -> final hidden states [B, S, D] (pre LM head)."""
        if rules is not None:
            raise NotImplementedError(
                "sharding rules (and pp through them) are ROADMAP Queue A "
                "item 7; the port runs on one device")
        s = tokens.shape[1]
        dt = self.cfg.dtype
        x = F.embedding(tokens, self.wte).to(dt) + self.wpe[:s].to(dt)[None]
        for block in self.blocks:
            x = block(x)
        return layer_norm(x, self.lnf_scale, self.lnf_bias)

    def forward(self, tokens, rules=None):
        """tokens [B, S] -> fp32 logits [B, S, vocab]."""
        x = self.forward_features(tokens, rules)
        return lm_logits(x, self.wte.to(self.cfg.dtype))

    def loss_fn(self, batch, rules=None, loss_chunk: int = 4096):
        """batch: {"tokens": [B, S+1]} -> next-token CE loss.

        The LM head and CE run in token chunks, each under
        ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``):
        only one chunk's fp32 logits are live, and the backward recomputes
        them. Padding to whole chunks uses ignore_id -1.
        """
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        x = self.forward_features(inputs, rules)
        d = x.shape[-1]
        wte = self.wte.to(self.cfg.dtype)

        xf = x.reshape(-1, d)
        tf = targets.reshape(-1)
        n = xf.shape[0]
        # Even chunks rounded to 256 tokens, as the JAX package cuts them.
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
            nll, count = checkpoint(_chunk_loss, xi, wte, ti,
                                    use_reentrant=False)
            nll_sum = nll_sum + nll
            denom = denom + count
        return nll_sum / denom.clamp_min(1.0)


def _chunk_loss(xi, wte, ti):
    return cross_entropy_sums(lm_logits(xi, wte), ti)


def flops_per_token(cfg: GPT2Config, seq: int) -> float:
    """Training FLOPs/token: 6N + attention term (PaLM appendix formula)."""
    attn = 12 * cfg.num_layers * cfg.d_model * seq
    return 6.0 * cfg.num_params() + attn
