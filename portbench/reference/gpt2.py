"""Plain GPT-2 training in fp32: the yardstick ``correct`` is decided by.

It imports torch and numpy only: nothing of the program under test, of
the JAX package or of JAX. It takes the benchmark's inputs (the initial
weights and the token batches the benchmark made from the seed) and
computes the configuration's training step from its published equations:

- learned token and position embeddings, pre-LN blocks (LayerNorm with
  eps 1e-5 and the population variance, fused QKV, causal softmax
  attention scaled by 1/sqrt(head size), output projection, tanh-GELU
  MLP), final LayerNorm, tied LM head, mean next-token cross-entropy;
- the gradients by autograd;
- Adafactor as optax's ``adafactor(lr)`` with its defaults (factored
  second moments with decay 1 - t^-0.8 and eps 1e-30 for leaves whose two
  largest axes reach 128, block-RMS clipping at 1, -lr, the parameter's
  block RMS at least 1e-3), on the JAX package's leaves: each kind of
  block parameter stacked over the layers ``[L, ...]``.

Every product and sum is fp32 with TF32 off (``fp32_products``). The
parameters are stored as the configuration states them (bf16 in both
cells): each update is computed in fp32 and the sum ``p + u`` rounded to
that type once, as ``optax.apply_updates`` does on bf16 parameters.

``precision="fp8"`` is the control, the step a later change to the
program could be tempted to take: every tensor the program holds in the
configuration's bf16 is held in float8 e4m3 with a per-tensor scale (amax
/ 448) instead: each product's operands and results, the embeddings and
the residual stream. Norms, softmax, the logits and the loss stay fp32, as
in the program. The rounding is in the forward pass; the backward products
read the rounded operands and gradients pass the roundings unchanged.

The memory is bounded by recomputation: each block and each chunk of the
loss's tokens runs under ``torch.utils.checkpoint``, and attention over
more than ``ATTN_CHUNK`` queries runs a chunk of queries at a time
against the keys it may see.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-5
ATTN_CHUNK = 1024
CE_CHUNK = 8192
# optax's adafactor defaults.
DECAY_RATE = 0.8
EPS = 1e-30
MIN_DIM_TO_FACTOR = 128
CLIPPING_THRESHOLD = 1.0
MIN_SCALE = 1e-3
FP8_MAX = 448.0
BLOCK_LEAVES = ("ln1_scale", "ln1_bias", "qkv_w", "qkv_b", "proj_w",
                "proj_b", "ln2_scale", "ln2_bias", "mlp_in_w", "mlp_in_b",
                "mlp_out_w", "mlp_out_b")


@contextlib.contextmanager
def fp32_products() -> Iterator[None]:
    """fp32 matrix products at full precision (no TF32, no reduced-precision
    reductions) for the duration; the settings come back afterwards."""
    cuda = torch.backends.cuda.matmul
    saved = (torch.get_float32_matmul_precision(), cuda.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    cuda.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        cuda.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A product's operand as ``precision`` holds it; the gradient passes
    through unchanged."""
    if precision == "fp32":
        return x
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


def _mm(a, b, precision):
    return _round(a, precision) @ _round(b, precision)


def layer_norm(x, scale, bias):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def _attn_rows(q, k, v, q0: int, precision: str):
    """Causal attention of queries q0.. (q) against keys 0.. (k, v): the
    keys before q0 are all visible, the mask cuts the block from q0 on."""
    s = _mm(q / math.sqrt(q.shape[-1]), k.transpose(-1, -2), precision)
    n = q.shape[2]
    above = torch.ones(n, k.shape[2] - q0, dtype=torch.bool,
                       device=q.device).triu_(1)
    s[..., q0:].masked_fill_(above, float("-inf"))
    return _mm(torch.softmax(s, dim=-1), v, precision)


def attention(q, k, v, precision: str):
    s = q.shape[2]
    if s <= ATTN_CHUNK:
        return _attn_rows(q, k, v, 0, precision)
    outs = []
    for q0 in range(0, s, ATTN_CHUNK):
        e = min(s, q0 + ATTN_CHUNK)
        outs.append(checkpoint(_attn_rows, q[:, :, q0:e], k[:, :, :e],
                               v[:, :, :e], q0, precision,
                               use_reentrant=False))
    return torch.cat(outs, dim=2)


def block(x, w: Dict[str, torch.Tensor], heads: int, precision: str):
    b, s, d = x.shape
    hd = d // heads
    r = lambda t: _round(t, precision)  # noqa: E731
    y = layer_norm(x, w["ln1_scale"], w["ln1_bias"])
    qkv = r(_mm(y, w["qkv_w"], precision) + w["qkv_b"])
    q, k, v = (t.reshape(b, s, heads, hd).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    o = attention(q, k, v, precision).transpose(1, 2).reshape(b, s, d)
    x = r(x + r(_mm(o, w["proj_w"], precision) + w["proj_b"]))
    y = layer_norm(x, w["ln2_scale"], w["ln2_bias"])
    h = gelu_tanh(r(_mm(y, w["mlp_in_w"], precision) + w["mlp_in_b"]))
    return r(x + r(_mm(h, w["mlp_out_w"], precision) + w["mlp_out_b"]))


def _nll_sum(x, wte, targets, precision):
    logits = _mm(x, wte.t(), precision)
    gold = logits.gather(-1, targets[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def loss(params: Dict[str, torch.Tensor], tokens: torch.Tensor, heads: int,
         precision: str = "fp32") -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` [B, S + 1]."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    s = inputs.shape[1]
    x = _round(F.embedding(inputs, params["wte"]) + params["wpe"][:s],
               precision)
    layers = {n: params[f"blocks.{n}"].unbind(0) for n in BLOCK_LEAVES}
    for j in range(len(layers["qkv_w"])):
        w = {n: layers[n][j] for n in BLOCK_LEAVES}
        x = checkpoint(block, x, w, heads, precision, use_reentrant=False)
    x = layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    xf, tf = x.reshape(-1, x.shape[-1]), targets.reshape(-1)
    total = x.new_zeros(())
    for i in range(0, xf.shape[0], CE_CHUNK):
        total = total + checkpoint(_nll_sum, xf[i:i + CE_CHUNK],
                                   params["wte"], tf[i:i + CE_CHUNK],
                                   precision, use_reentrant=False)
    return total / xf.shape[0]


def _factored_dims(shape: Sequence[int]):
    if len(shape) < 2:
        return None
    order = np.argsort(tuple(shape))
    if shape[order[-2]] < MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor:
    """optax's ``adafactor(lr)`` with its defaults, in fp32, on leaves."""

    def __init__(self, lr: float):
        self.lr = lr
        self.count = 0
        self.state: Dict[str, tuple] = {}

    def updates(self, params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        t = self.count + 1.0
        decay = 1.0 - t ** -DECAY_RATE
        out = {}
        for name, g in grads.items():
            g_sq = g * g + EPS
            dims = _factored_dims(g.shape)
            if dims is None:
                v = self.state.get(name, (torch.zeros_like(g),))[0]
                v = decay * v + (1.0 - decay) * g_sq
                self.state[name] = (v,)
                u = g * v.rsqrt()
            else:
                d1, d0 = dims
                vr, vc = self.state.get(name, (0.0, 0.0))
                vr = decay * vr + (1.0 - decay) * g_sq.mean(d0)
                vc = decay * vc + (1.0 - decay) * g_sq.mean(d1)
                self.state[name] = (vr, vc)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row = (vr / vr.mean(reduced_d1, keepdim=True)).rsqrt()
                u = g * row.unsqueeze(d0) * vc.rsqrt().unsqueeze(d1)
            rms = u.square().mean().sqrt()
            u = u / (rms / CLIPPING_THRESHOLD).clamp_min(1.0)
            u = u * -self.lr
            p_rms = params[name].square().mean().sqrt().clamp_min(MIN_SCALE)
            out[name] = u * p_rms
        self.count += 1
        return out


# Leaves whose last axis holds several projections, fused: each part is a
# parameter of its own in the comparison, so that a part whose gradient is
# nought to rounding (the key bias, under softmax) can be told apart.
PARTS = {"blocks.qkv_w": 3, "blocks.qkv_b": 3}


def unit_norms(leaf: str, t: torch.Tensor) -> torch.Tensor:
    """fp32 L2 norms of a leaf stacked ``[L, ...]`` (``[1, ...]`` for a leaf
    outside the blocks): one a layer, or one a layer and part for a fused
    leaf (``PARTS``), layer-major."""
    k = PARTS.get(leaf, 1)
    t = t.float()
    t = t.reshape(t.shape[0], -1, k, t.shape[-1] // k)
    return t.transpose(1, 2).flatten(2).norm(dim=2).flatten()


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``unit_norms`` of each leaf of a parameter tree (JAX's layout)."""
    return {n: unit_norms(n, t if n.startswith("blocks.") else t[None])
            for n, t in tensors.items()}


def train(params: Dict[str, torch.Tensor], batches: List[torch.Tensor],
          heads: int, lr: float, precision: str = "fp32",
          param_dtype: torch.dtype = torch.bfloat16) -> Dict:
    """``len(batches)`` training steps from ``params`` (not changed), the
    parameters stored in ``param_dtype``. Returns each step's loss, the
    first step's gradient norms and the norms of the parameters' change
    after the last step, by leaf (``leaf_norms``)."""
    p0 = {n: t.detach() for n, t in params.items()}
    cur = {n: t.detach().float().clone().requires_grad_()
           for n, t in params.items()}
    opt = Adafactor(lr)
    losses, first = [], None
    with fp32_products():
        for tokens in batches:
            value = loss(cur, tokens, heads, precision)
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
