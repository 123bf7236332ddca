"""GPT-2 family, dense path: counterpart of the JAX package's
``models/gpt2.py``.

Learned positional embeddings, pre-LN blocks with fused QKV, causal flash
attention (the port's CUDA kernels on the card), tanh-GELU MLP, and the
tied LM head with fp32 logits and a chunked cross-entropy. Parameters keep
the JAX package's names and layouts (``qkv_w`` is ``[d, 3d]``, applied as
``y @ w``), one ``Block`` per layer where JAX stacks them ``[L, ...]``;
``convert.py`` carries a JAX pytree across.

Activations run in ``cfg.dtype`` (bf16); layer norms, logits and the loss
in fp32.

Under a mesh (``train.step.build_sharded_train``: the parameters are
DTensors placed by the sharding rules, ``sharding.current_mesh`` is set)
the dense parts run as DTensor ops, redistributed by ``constrain`` where
the JAX package constrains, and everything that takes raw tensors runs on
local shards inside ``sharding.smap``, as the JAX package's ``shard_map``
regions: the embedding lookup, attention (the flash kernels, or the ring
and Ulysses bodies for ``attention_impl`` "ring"/"ulysses"), the MoE FFN
(``parallel/moe.py``, all_to_all over ``ep`` when the mesh has it), the
GPipe pipeline over ``pp`` (rules ``{"layers": "pp"}``, the layers
stacked ``[L, ...]`` by ``stack_layers`` and sharded over pp, a stage
holding its own) and the chunked loss. Without a mesh the same code runs
on plain tensors. MoE blocks (``num_experts`` > 0) replace the dense MLP
with a top-k routed mixture and add ``moe_aux_weight * aux /
num_layers`` to the loss; they do not run under pp (the JAX package
refuses pp with MoE too).

Remat (``remat_policy``) keeps the saved set of the JAX package's policy
of the same name and recomputes the rest of the block in the backward,
on ``torch.utils.checkpoint``. A block is five parts, each named for the
tensor it makes (the JAX package's ``checkpoint_name`` tags):

  qkv      ln1 and the fused QKV product
  attn     heads, flash attention (K1) -> ``attn_out`` and ``attn_lse``
  proj     the output projection plus the residual
  mlp_in   ln2 and the first MLP product
  mlp_out  tanh-GELU and the second MLP product

A MoE block (``parallel/moe.py``) has no ``mlp_in``; its first three parts
are the dense block's, then:

  router    ln2 and the router product (logits, fp32)
  aux       the load-balance loss of the routing
  route     top-k routing to fixed-capacity slots (dispatch and combine)
  dispatch  ln2 again and the dispatch product (tokens to expert slots)
  experts   the expert products (all_to_all over ep around them)
  combine   the combine product (expert slots back to tokens)

A policy keeps the outputs of some parts (``REMAT_KEEPS``,
``MOE_REMAT_KEEPS``). The block is cut after each kept part; each run of
parts between cuts is one checkpointed region, whose inputs are all it
holds for the backward, so what a region keeps is visible to
``saved_tensors_hooks``. A kept attention runs outside any region: its
autograd node holds q, k, v (the ``qkv`` tag, in head layout), o and
lse, and K1 is not run again in the backward. Routing is never held
across a cut: a region that reads it routes again from the router's
logits, as the JAX package's backward does. In a recompute, the last part
of a region skips its product: its output is read by no backward, as XLA
drops it from the JAX package's recompute. Under a mesh the MoE parts of
a region run in one ``smap`` region on each rank's tokens.
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
from ..parallel.sharding import (P, constrain, current_mesh, is_dtensor,
                                 mesh_sizes, smap, spec_axes, spec_for)
from .common import (chunked_cross_entropy, layer_norm, lm_logits,
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
    attention_impl: str = "auto"  # auto|flash|reference|ring|ulysses
    # none|full|dots|dots_attn|mem|mem2 (REMAT_KEEPS). The JAX package's
    # default is "dots", and its remat=False reads as "none" here.
    remat_policy: str = "none"
    # MoE FFN: >0 replaces every block's dense MLP with a top-k routed
    # mixture over ``num_experts`` experts sharded on the ``ep`` mesh axis.
    # Ring and Ulysses run over the ``sp`` axis.
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

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


_IMPLS = ("auto", "flash", "reference", "ring", "ulysses")


def _check_supported(cfg: GPT2Config) -> None:
    if cfg.attention_impl not in _IMPLS:
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    if cfg.remat_policy != "none" and cfg.remat_policy not in REMAT_KEEPS:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; one "
                         f"of none, {', '.join(REMAT_KEEPS)}")


def block_logical_axes(cfg: GPT2Config) -> Dict[str, tuple]:
    """Logical axes of one block's parameters: the JAX package's block
    axes without the leading "layers" (one module a layer here)."""
    axes = {
        "ln1_scale": (None,), "ln1_bias": (None,),
        "qkv_w": ("embed", "qkv"), "qkv_b": ("qkv",),
        "proj_w": ("qkv", "embed"), "proj_b": ("embed",),
        "ln2_scale": (None,), "ln2_bias": (None,),
    }
    if cfg.num_experts > 0:
        axes.update({"router_w": ("embed", None),
                     "moe_in_w": ("expert", "embed", "mlp"),
                     "moe_out_w": ("expert", "mlp", "embed")})
    else:
        axes.update({"mlp_in_w": ("embed", "mlp"), "mlp_in_b": ("mlp",),
                     "mlp_out_w": ("mlp", "embed"), "mlp_out_b": ("embed",)})
    return axes


def _attend(q, k, v, cfg: GPT2Config, rules):
    """Causal attention by ``cfg.attention_impl``. DTensors go through an
    ``smap`` region: the flash kernels on whole sequences, or the ring /
    Ulysses body on sequence shards. Plain tensors run the kernels (or,
    inside another region, the sequence-parallel body) directly."""
    impl = cfg.attention_impl
    if impl == "ring":
        from ..parallel.ring import ring_attention_local as seq_body
    elif impl == "ulysses":
        from ..parallel.ulysses import ulysses_attention_local as seq_body
    else:
        seq_body = None

    def body(q, k, v):
        if seq_body is None:
            return attention_op(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True, impl=impl)
        return seq_body(q, k, v, axis_name="sp")

    if is_dtensor(q):
        spec = spec_for(("batch", "heads", None if seq_body is None
                         else "seq", None), rules)
        return smap(body, current_mesh(), in_specs=(spec, spec, spec),
                    out_specs=spec)(q, k, v)
    if seq_body is not None and current_mesh() is None:
        raise RuntimeError(
            f"attention_impl={impl!r} needs an ambient mesh "
            "(run via build_sharded_train or sharding.use_mesh)")
    return body(q, k, v)


# The parts of a block, with the earlier outputs each one reads ("x" is
# the block's input). A dense block returns proj + mlp_out, a MoE block
# proj + combine (and aux).
_READS = {"qkv": ("x",), "attn": ("qkv",), "proj": ("x", "attn"),
          "mlp_in": ("proj",), "mlp_out": ("mlp_in",),
          "router": ("proj",), "aux": ("router",), "route": ("router",),
          "dispatch": ("proj", "route"), "experts": ("dispatch",),
          "combine": ("route", "experts")}
_PART_NAMES = ("qkv", "attn", "proj", "mlp_in", "mlp_out")
_MOE_PARTS = ("router", "aux", "route", "dispatch", "experts", "combine")
_MOE_PART_NAMES = _PART_NAMES[:3] + _MOE_PARTS
# The weights each MoE part reads.
_MOE_WEIGHTS = {"router": ("ln2_scale", "ln2_bias", "router_w"),
                "dispatch": ("ln2_scale", "ln2_bias"),
                "experts": ("moe_in_w", "moe_out_w")}

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


# The MoE block's saved sets, as JAX's saved residuals of the same block
# (``jax.ad_checkpoint.print_saved_residuals``): "dots" keeps the qkv and
# proj products, the router's logits and the dispatch product (tokens to
# slots), the products without a batch dimension; the expert products
# (batch dimension e) and routing are recomputed, and the combine
# product's output is read by no backward. "dots_attn" adds attention;
# "mem" and "mem2" keep qkv and attention (a MoE block has no mlp_in).
MOE_REMAT_KEEPS: Dict[str, frozenset] = {
    "full": frozenset(),
    "dots": frozenset({"qkv", "proj", "router", "dispatch"}),
    "dots_attn": frozenset({"qkv", "attn", "proj", "router", "dispatch"}),
    "mem": frozenset({"qkv", "attn"}),
    "mem2": frozenset({"qkv", "attn"}),
}


def _regions(keep: frozenset, parts=_PART_NAMES):
    """The runs of parts between cuts: a cut follows each kept part. A
    run that reads the routing without computing it routes again."""
    runs, run = [], []
    for name in parts:
        run.append(name)
        if name in keep or name == parts[-1]:
            runs.append(run)
            run = []
    for run in runs:
        readers = [i for i, n in enumerate(run) if "route" in _READS[n]]
        if readers and "route" not in run:
            run.insert(readers[0], "route")
    return [tuple(run) for run in runs]


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


class _Einsum(torch.autograd.Function):
    """``torch.einsum(eq, a, b)`` inside a checkpointed region. Saves a and
    b; with ``skip`` (a region's last product, in its recompute) the output
    is left uncomputed. Every index of an operand is in the other operand
    or the output, so each gradient is one einsum."""

    @staticmethod
    def forward(ctx, eq, a, b, skip: bool):
        ctx.eq = eq
        ctx.save_for_backward(a, b)
        if skip:
            (sa, sb), out = eq.split("->")[0].split(","), eq.split("->")[1]
            size = dict(zip(sa, a.shape)) | dict(zip(sb, b.shape))
            return a.new_empty([size[c] for c in out])
        return torch.einsum(eq, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        sa, sb = ins.split(",")
        ga = (torch.einsum(f"{out},{sb}->{sa}", g, b)
              if ctx.needs_input_grad[1] else None)
        gb = (torch.einsum(f"{sa},{out}->{sb}", a, g)
              if ctx.needs_input_grad[2] else None)
        return None, ga, gb, None


def _product(eq, a, b, skip: Optional[bool]):
    """``torch.einsum(eq, a, b)``; ``skip`` None outside a region."""
    if skip is None:
        return torch.einsum(eq, a, b)
    return _Einsum.apply(eq, a, b, skip)


class Block(nn.Module):
    """One pre-LN transformer block (``_block`` in the JAX package).
    ``forward(x, rules)`` returns (x, aux): aux is the router's
    load-balance loss in a MoE block, 0 otherwise."""

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
        if cfg.num_experts > 0:
            e = cfg.num_experts
            self.router_w = tn((d, e))
            self.moe_in_w = tn((e, d, m))
            self.moe_out_w = tn((e, m, d), proj_std)
        else:
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

    def _part(self, name: str, inputs, skip: Optional[bool], rules):
        if name == "qkv":
            (x,) = inputs
            y = layer_norm(x, self.ln1_scale, self.ln1_bias)
            qkv = self._dense(y, self.qkv_w, self.qkv_b, skip)
            return constrain(qkv, ("batch", "seq", "qkv"), rules)
        if name == "attn":
            (qkv,) = inputs
            b, s, _ = qkv.shape
            h, hd = self.cfg.num_heads, self.cfg.head_dim
            # [B,S,D] -> [B,H,S,hd]
            q, k, v = (t.reshape(b, s, h, hd).transpose(1, 2)
                       for t in qkv.split(h * hd, dim=-1))
            return _attend(q, k, v, self.cfg, rules)
        if name == "proj":
            x, o = inputs
            o = o.transpose(1, 2).reshape(x.shape)
            o = self._dense(o, self.proj_w, self.proj_b, skip)
            return x + constrain(o, ("batch", "seq", None), rules)
        if name == "mlp_in":
            (x,) = inputs
            y = layer_norm(x, self.ln2_scale, self.ln2_bias)
            hdn = self._dense(y, self.mlp_in_w, self.mlp_in_b, skip)
            return constrain(hdn, ("batch", "seq", "mlp"), rules)
        (hdn,) = inputs
        hdn = F.gelu(hdn, approximate="tanh")
        out = self._dense(hdn, self.mlp_out_w, self.mlp_out_b, skip)
        return constrain(out, ("batch", "seq", None), rules)

    def _run(self, run, outputs, rc: Optional[_Recompute], rules, *tensors):
        """Parts ``run`` from their inputs (``tensors``, named as
        ``_inputs(run)``); returns the named ``outputs``. Under ``rc`` the
        run is a checkpointed region and its last product is skipped in
        the recompute. The MoE parts, last in a run, run together
        (``_moe_parts``)."""
        env = dict(zip(_inputs(run), tensors))
        moe = [n for n in run if n in _MOE_PARTS]
        for name in run[:len(run) - len(moe)]:
            skip = None if rc is None else (rc.active and name == run[-1])
            env[name] = self._part(name, [env[i] for i in _READS[name]],
                                   skip, rules)
        if moe:
            skip = None if rc is None else rc.active
            env.update(self._moe_parts(tuple(moe), env, outputs, skip,
                                       rules))
        return tuple(env[n] for n in outputs)

    def _moe_parts(self, run, env, outputs, skip_last, rules):
        """MoE parts ``run`` on ``env``; returns those of ``outputs`` they
        make. Under a mesh they run in one ``smap`` region: with an ``ep``
        axis each rank routes its own (batch, seq) shard of the tokens
        (the batch rule must include ep) to experts sharded over ep, and
        aux is averaged over the mesh; otherwise every rank routes the
        whole batch together (``axis_name=None``), as the JAX package does
        without an ep axis."""
        from ..parallel.collective import pmean
        from ..parallel.moe import (expert_ffn, load_balance_loss, route,
                                    router_topk)

        cfg = self.cfg
        e, k = cfg.num_experts, cfg.moe_top_k
        ins = _inputs(run)
        outs = tuple(n for n in run if n in outputs)
        wnames = tuple(dict.fromkeys(
            w for n in run for w in _MOE_WEIGHTS.get(n, ())))
        mesh = current_mesh()
        sharded = is_dtensor(env[ins[0]])
        have_ep = sharded and mesh_sizes(mesh).get("ep", 1) > 1

        def part(name, inputs, w, skip):
            if name == "router":
                (x,) = inputs
                y = layer_norm(x, w["ln2_scale"], w["ln2_bias"])
                return _product("bsd,de->bse", y.float(),
                                w["router_w"].float(), skip)
            if name == "aux":
                (logits,) = inputs
                _, idx, probs = router_topk(logits.reshape(-1, e), k)
                aux = load_balance_loss(probs, idx, e)
                return (pmean(aux, tuple(mesh.mesh_dim_names)) if have_ep
                        else aux)
            if name == "route":
                (logits,) = inputs
                b, s, _ = logits.shape
                return tuple(t.reshape(b, s, e, -1) for t in route(
                    logits.reshape(b * s, e), e, k, cfg.moe_capacity_factor))
            if name == "dispatch":
                x, (dispatch, _) = inputs
                y = layer_norm(x, w["ln2_scale"], w["ln2_bias"])
                return _product("bsec,bsm->ecm", dispatch, y.float(), skip)
            if name == "experts":
                (slots,) = inputs
                return expert_ffn(slots, w["moe_in_w"], w["moe_out_w"],
                                  "ep" if have_ep else None)
            (_, combine), y = inputs
            return _product("bsec,ecm->bsm", combine, y, skip).to(cfg.dtype)

        def body(*args):
            local = dict(zip(ins, args))
            w = dict(zip(wnames, args[len(ins):]))
            for name in run:
                skip = (None if skip_last is None
                        else skip_last and name == run[-1])
                local[name] = part(name, [local[r] for r in _READS[name]],
                                   w, skip)
            return tuple(local[n] for n in outs)

        args = [env[n] for n in ins] + [getattr(self, w) for w in wnames]
        if not sharded:
            return dict(zip(outs, body(*args)))
        # Specs: tensors [B, S, ...] are split as the tokens, expert slots
        # [E, C, m] are one block a rank (dim 0 over the tokens' axes),
        # aux is replicated.
        tok = spec_for(("batch", "seq", None), rules) if have_ep else P()
        axes = set(spec_axes(tok))
        slots = P(tuple(a for a in mesh.mesh_dim_names if a in axes) or None)
        kind = {"aux": P(), "dispatch": slots, "experts": slots}
        w_spec = spec_for(("expert",), rules) if have_ep else P()
        in_specs = tuple(kind.get(n, tok) for n in ins) + tuple(
            w_spec if w.startswith("moe_") else P() for w in wnames)
        res = smap(body, mesh, in_specs=in_specs,
                   out_specs=tuple(kind.get(n, tok) for n in outs))(*args)
        return dict(zip(outs, res))

    def forward(self, x, rules=None):
        moe = self.cfg.num_experts > 0
        parts = _MOE_PART_NAMES if moe else _PART_NAMES
        last = parts[-1]
        policy = self.cfg.remat_policy
        keeps = MOE_REMAT_KEEPS if moe else REMAT_KEEPS
        runs = ([parts] if policy == "none"
                else _regions(keeps[policy], parts))
        finals = {"proj", last, "aux"}
        env = {"x": x}
        moe_in = None
        for i, run in enumerate(runs):
            later = {n for nxt in runs[i + 1:] for n in _inputs(nxt)}
            outputs = tuple(n for n in run if n in later | finals)
            if moe and moe_in is None and "proj" in env:
                # Regions after the cut read the MoE branch's input through
                # one view, whose gradient is their sum before the
                # residual's is added: the order of the bf16 sums stays
                # the one without remat.
                moe_in = env["proj"].view_as(env["proj"])
            ins = [moe_in if n == "proj" and moe_in is not None else env[n]
                   for n in _inputs(run)]
            if policy == "none" or run == ("attn",):
                # No remat, or a kept attention: _Flash's node holds q, k,
                # v, o and lse.
                outs = self._run(run, outputs, None, rules, *ins)
            else:
                rc = _Recompute()
                outs = checkpoint(self._run, run, outputs, rc, rules, *ins,
                                  use_reentrant=False,
                                  context_fn=rc.contexts)
            env.update(zip(outputs, outs))
        if not moe:
            return env["proj"] + env["mlp_out"], 0.0
        out = constrain(env["combine"], ("batch", "seq", None), rules)
        return env["proj"] + out, env["aux"]


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
        self.layers = None  # the blocks' parameters once stacked

    def stack_layers(self) -> None:
        """Hold the blocks' parameters stacked ``[L, ...]`` as
        ``layers.<name>``, the JAX package's ``blocks`` leaves, in place of
        the per-layer blocks. A rule that maps "layers" to a mesh axis then
        shards them: under pp each stage holds, updates and keeps
        optimizer state for its own layers only. The layers run through a
        block without parameters (``torch.func.functional_call``)."""
        if self.layers is not None:
            return
        names = [n for n, _ in self.blocks[0].named_parameters()]
        self.layers = nn.ParameterDict({
            n: nn.Parameter(torch.stack([getattr(b, n).detach()
                                         for b in self.blocks]))
            for n in names})
        self._template = (self.blocks[0].to("meta"),)  # not a submodule
        del self.blocks

    def _layer(self, params: Dict[str, torch.Tensor], j: int, x, rules):
        """Layer ``j`` of stacked ``params`` (``layers``' names) on x."""
        from torch.func import functional_call

        return functional_call(self._template[0],
                               {n: t[j] for n, t in params.items()},
                               (x, rules))

    def logical_axes(self) -> Dict[str, tuple]:
        """Logical axes of every parameter, by name (the JAX package's
        ``init_params`` axes; a per-layer block's without the "layers"
        dim)."""
        axes = {"wte": ("vocab", "embed"), "wpe": (None, "embed"),
                "lnf_scale": (None,), "lnf_bias": (None,)}
        for name, ax in block_logical_axes(self.cfg).items():
            if self.layers is not None:
                axes[f"layers.{name}"] = ("layers",) + ax
                continue
            for i in range(self.cfg.num_layers):
                axes[f"blocks.{i}.{name}"] = ax
        return axes

    def _embed(self, tokens, rules):
        """Token and position embeddings in ``cfg.dtype``. On a mesh the
        table is gathered whole and the lookup runs on each rank's
        (batch, seq) shard of the indices, as the JAX package's
        ``_embed_lookup``."""
        s = tokens.shape[1]
        dt = self.cfg.dtype
        wte = constrain(self.wte, (None, None), rules)
        wpe = constrain(self.wpe, (None, None), rules)
        if is_dtensor(wte):
            x = smap(lambda w, t: F.embedding(t, w), current_mesh(),
                     in_specs=(P(), spec_for(("batch", "seq"), rules)),
                     out_specs=spec_for(("batch", "seq", None), rules))(
                wte, tokens)
        else:
            x = F.embedding(tokens, wte)
        x = x.to(dt) + wpe[:s].to(dt)[None]
        return constrain(x, ("batch", "seq", None), rules)

    def forward_features(self, tokens, rules=None):
        """tokens [B, S] -> (final hidden states [B, S, D], aux): aux is
        the sum of the MoE blocks' router losses (0 without MoE)."""
        if _pp_axis_size(rules) > 1:
            return self._pp_forward_features(tokens, rules)
        x = self._embed(tokens, rules)
        aux = 0.0
        for j in range(self.cfg.num_layers):
            if self.layers is None:
                x, a = self.blocks[j](x, rules)
            else:
                x, a = self._layer(dict(self.layers), j, x, rules)
            aux = aux + a
        return layer_norm(x, self.lnf_scale, self.lnf_bias), aux

    def _pp_forward_features(self, tokens, rules):
        """GPipe over the ``pp`` mesh axis (``parallel/pipeline.py``):
        stage i runs layers [i*L/pp, (i+1)*L/pp) on microbatches of its
        (batch, seq) shard, inside one ``smap`` region; embedding and the
        final norm run outside it. The layers are stacked
        (``stack_layers``) and sharded over pp by the "layers" rule, so a
        stage holds its own layers' parameters and gets their gradients
        alone, as the JAX package's ``P("pp")`` blocks."""
        from ..parallel.pipeline import (num_microbatches_for,
                                         pipeline_apply_local)

        if self.cfg.num_experts > 0:
            raise NotImplementedError(
                "pp+MoE is not supported: the pipeline carry does not thread "
                "the router aux loss (as in the JAX package); train MoE with "
                "dp/fsdp/ep axes instead")
        if self.layers is None:
            raise ValueError("pp needs the layers stacked: GPT2.stack_layers"
                             "() (build_sharded_train stacks them when the "
                             "rules map 'layers' to a mesh axis)")
        pp = _pp_axis_size(rules)
        per = self.cfg.num_layers // pp
        if per * pp != self.cfg.num_layers:
            raise ValueError(f"{self.cfg.num_layers} layers do not divide "
                             f"into {pp} stages")
        m = num_microbatches_for(tokens.shape[0], pp)
        x = self._embed(tokens, rules)
        data_spec = spec_for(("batch", "seq", None), rules)

        def stage_fn(params, xmb):
            for j in range(per):
                xmb, _ = self._layer(params, j, xmb, None)
            return xmb

        def body(params, xl):
            bl, sl, d = xl.shape
            if bl % m:
                raise ValueError(f"{m} microbatches do not divide this "
                                 f"rank's batch of {bl}")
            out = pipeline_apply_local(stage_fn, params,
                                       xl.reshape(m, bl // m, sl, d), "pp")
            return out.reshape(bl, sl, d)

        x = smap(body, current_mesh(),
                 in_specs=(spec_for(("layers",), rules), data_spec),
                 out_specs=data_spec)(dict(self.layers), x)
        return layer_norm(x, self.lnf_scale, self.lnf_bias), 0.0

    def forward(self, tokens, rules=None):
        """tokens [B, S] -> fp32 logits [B, S, vocab] (without a mesh)."""
        x, _ = self.forward_features(tokens, rules)
        return lm_logits(x, self.wte.to(self.cfg.dtype))

    def loss_fn(self, batch, rules=None, loss_chunk: int = 4096):
        """batch: {"tokens": [B, S+1]} -> next-token CE loss, plus
        ``moe_aux_weight * aux / num_layers`` with MoE.

        The LM head and CE run in token chunks, each under
        ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``):
        only one chunk's fp32 logits are live, and the backward recomputes
        them. Padding to whole chunks uses ignore_id -1. On a mesh each
        rank chunks its own (batch, seq) shard, and the sums are psummed
        over the axes that shard them.
        """
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        x, aux = self.forward_features(inputs, rules)
        wte = self.wte.to(self.cfg.dtype)
        if is_dtensor(x):
            from ..parallel.collective import psum

            x_spec = spec_for(("batch", "seq", None), rules)
            axes = spec_axes(x_spec)

            def body(x, wte, t):
                nll, count = chunked_cross_entropy(x, wte, t, loss_chunk)
                return psum(nll, axes), psum(count, axes)

            nll_sum, denom = smap(
                body, current_mesh(),
                in_specs=(x_spec, P(), spec_for(("batch", "seq"), rules)),
                out_specs=(P(), P()))(x, wte, targets)
        else:
            nll_sum, denom = chunked_cross_entropy(x, wte, targets,
                                                   loss_chunk)
        loss = nll_sum / denom.clamp_min(1.0)
        if self.cfg.num_experts > 0:
            loss = loss + self.cfg.moe_aux_weight * aux / self.cfg.num_layers
        return loss


def _pp_axis_size(rules) -> int:
    """Size of the pp mesh axis if the current mesh pipelines layers."""
    mesh = current_mesh()
    if mesh is None or rules is None or rules.get("layers") != "pp":
        return 1
    return mesh_sizes(mesh).get("pp", 1)


def flops_per_token(cfg: GPT2Config, seq: int) -> float:
    """Training FLOPs/token: 6N + attention term (PaLM appendix formula)."""
    attn = 12 * cfg.num_layers * cfg.d_model * seq
    return 6.0 * cfg.num_params() + attn
