"""Attention ops: hand-written CUDA flash attention (H100) + plain versions.

Counterpart of the JAX package's ``ops/attention.py``. Shapes: q
``[B, H, Sq, D]``, k/v ``[B, H, Sk, D]``; lse is fp32 ``[B, H, Sq]``.

Six kernels, each with a plain PyTorch version beside it, launched and
counted under the wrapper's name through ``_build.launch``. The Hopper
kernels (``KERNEL_WRAPPERS``: TMA, mbarriers and wgmma) take bf16 or fp16
at head_dim 64 or 128:

  - ``flash_fwd`` (csrc/flash_fwd.cu): o and lse; plain version
    ``mha_reference_with_lse``;
  - ``flash_bwd_dkdv`` (csrc/flash_bwd_dkdv.cu): dk and dv; plain version
    ``flash_bwd_dkdv_reference``;
  - ``flash_bwd_dq`` (csrc/flash_bwd_dq.cu): dq; plain version
    ``flash_bwd_dq_reference``.

The general kernels (``GENERAL_WRAPPERS``: CUDA cores, fp32 sums) take
the rest, as the Pallas kernels compute every dtype and head_dim in their
own body: fp32, bf16 or fp16 at any head_dim from 1 to 256.
``flash_fwd_general``, ``flash_bwd_dkdv_general`` and
``flash_bwd_dq_general`` (csrc/*_general.cu) have the same plain versions.

A wrapper runs the plain version for tensors off the card
(``_build.on_card``). For a CUDA tensor it launches its kernel or raises:
on a dtype or head_dim its kernel does not take, non-contiguous or
(Hopper) misaligned input, or a kernel that cannot be built. The kernels
mask ragged Sq and Sk themselves, so every such shape goes to them.

The entry points (``flash_attention``, ``attention``,
``attention_with_lse``) pick the kernels from the dtype and the head_dim
alone (``kernels_for``), before any launch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..observability import tracing
from . import _build

_NEG_INF = -1e30
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The kernels' C entry points, one a library of the same name; each group
# is built at once on its first launch.
_HOPPER = {
    "flash_fwd": {"flash_fwd": [_P] * 5 + [_I] * 6 + [_F, _I, _P]},
    "flash_bwd_dkdv": {"flash_bwd_dkdv": [_P] * 6 + [_I] + [_P] * 2
                       + [_I] * 6 + [_F, _I, _P]},
    "flash_bwd_dq": {"flash_bwd_dq": [_P] * 7 + [_I] * 6 + [_F, _I, _P]},
}
_GENERAL = {
    "flash_fwd_general": {
        "flash_fwd_general": [_P] * 5 + [_I] * 6 + [_F, _I, _P]},
    "flash_bwd_dkdv_general": {
        "flash_bwd_dkdv_general": [_P] * 8 + [_I] * 6 + [_F, _I, _P]},
    "flash_bwd_dq_general": {
        "flash_bwd_dq_general": [_P] * 7 + [_I] * 6 + [_F, _I, _P]},
}


# ---------------------------------------------------------------------------
# Plain versions (off the card, and what the kernels are held against).
# ---------------------------------------------------------------------------

def _scores(q, k, causal: bool, scale: float, q_offset: int = 0):
    """fp32 q k^T * scale with the causal mask at absolute positions."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
        k_pos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, _NEG_INF)
    return s


def mha_reference_with_lse(q, k, v, causal: bool = True,
                           scale: Optional[float] = None,
                           q_offset: int = 0):
    """Reference attention returning (o, lse [B,H,Sq] fp32). ``q_offset``
    shifts causal positions (ring steps). Fully masked rows produce
    lse ~= -1e30 (finite)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, causal, scale, q_offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", (p / l).to(v.dtype).float(),
                     v.float()).to(q.dtype)
    return o, (m + torch.log(l))[..., 0]


def mha_reference(q, k, v, causal: bool = True,
                  scale: Optional[float] = None, q_offset: int = 0):
    """Plain attention; ``q_offset`` shifts causal positions (ring steps)."""
    return mha_reference_with_lse(q, k, v, causal=causal, scale=scale,
                                  q_offset=q_offset)[0]


def _probs_and_ds(q, k, v, do, lse, delta, causal: bool, scale: float):
    """P = exp(s - lse) and dS = P (dO v^T - delta) scale in fp32, as the
    backward kernels recompute them tile by tile."""
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    return p, ds


def flash_bwd_dkdv_reference(q, k, v, do, lse, delta, causal: bool,
                             scale: float
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: (dk, dv), P and dS rounded to the operand
    type before their products, fp32 accumulation."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool,
                           scale: float) -> torch.Tensor:
    """Plain version of K3: dq = dS k (dS rounded to the operand type)."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(q.dtype).float(), k.float())
    return dq.to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
GENERAL_MAX_HEAD_DIM = 256


def hopper_takes(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the Hopper kernels take this input: bf16 or fp16 at
    head_dim 64 or 128."""
    return dtype in (torch.bfloat16, torch.float16) and head_dim in (64, 128)


def _check(q, k, v, do=None, general: bool = False) -> None:
    """Raises on what the kernels (the general ones with ``general``) do
    not take."""
    if q.ndim != 4:
        raise ValueError(f"flash kernels take [B,H,S,D], got "
                         f"{tuple(q.shape)}")
    if general:
        if q.dtype not in _DTYPE_CODE:
            raise TypeError(f"general flash kernels take fp32, bf16 or "
                            f"fp16, got {q.dtype}")
        if not 1 <= q.shape[-1] <= GENERAL_MAX_HEAD_DIM:
            raise ValueError(f"general flash kernels take head_dim 1 to "
                             f"{GENERAL_MAX_HEAD_DIM}, got {q.shape[-1]}")
    elif not hopper_takes(q.dtype, q.shape[-1]):
        raise TypeError(f"Hopper flash kernels take bf16 or fp16 at head_dim"
                        f" 64 or 128, got {q.dtype} at {q.shape[-1]}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} does not match q")
    for t in (q, k, v) if do is None else (q, k, v, do):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError("flash kernel operands differ in dtype/device")
        if not t.is_contiguous():
            raise ValueError("flash kernels take contiguous tensors")
        if not general and t.data_ptr() % 16:
            raise ValueError("flash kernels need 16-byte aligned tensors")


def _stats(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """lse or delta as the kernels read them: contiguous fp32 [B,H,Sq]."""
    if x.dtype != torch.float32 or x.shape != q.shape[:3]:
        raise ValueError(f"expected fp32 {tuple(q.shape[:3])}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def flash_fwd(q, k, v, causal: bool, scale: float):
    """K1: (o, lse). The kernel for CUDA tensors, the plain version
    otherwise."""
    if not _build.on_card(q):
        return mha_reference_with_lse(q, k, v, causal=causal, scale=scale)
    _check(q, k, v)
    b, h, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    _build.launch(_HOPPER, "flash_fwd", q.device, q, k, v, o, lse, b, h, sq,
                  k.shape[2], d, int(causal), float(scale),
                  int(q.dtype == torch.bfloat16))
    return o, lse


def _stats_rows(x: torch.Tensor, q: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """lse or delta as K2's TMA reads them: fp32 rows of Sq values, ``ld``
    apart, with ``ld`` a multiple of 4 (16 bytes). Only a ragged Sq that
    is not such a multiple pays for a padded copy."""
    x = _stats(x, q)
    sq = q.shape[2]
    ld = -(-sq // 4) * 4
    if ld != sq or x.data_ptr() % 16:
        x = torch.nn.functional.pad(x, (0, ld - sq))
    return x, ld


def flash_bwd_dkdv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """K2: (dk, dv). The kernel for CUDA tensors, the plain version
    otherwise."""
    if not _build.on_card(q):
        return flash_bwd_dkdv_reference(q, k, v, do, lse, delta, causal,
                                        scale)
    _check(q, k, v, do)
    b, h, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lse_rows, ld = _stats_rows(lse, q)
    delta_rows, _ = _stats_rows(delta, q)
    _build.launch(_HOPPER, "flash_bwd_dkdv", q.device, q, k, v, do, lse_rows,
                  delta_rows, ld, dk, dv, b, h, sq, k.shape[2], d,
                  int(causal), float(scale), int(q.dtype == torch.bfloat16))
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    """K3: dq. The kernel for CUDA tensors, the plain version otherwise."""
    if not _build.on_card(q):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale)
    _check(q, k, v, do)
    b, h, sq, d = q.shape
    dq = torch.empty_like(q)
    _build.launch(_HOPPER, "flash_bwd_dq", q.device, q, k, v, do,
                  _stats(lse, q), _stats(delta, q), dq, b, h, sq, k.shape[2],
                  d, int(causal), float(scale),
                  int(q.dtype == torch.bfloat16))
    return dq


def flash_fwd_general(q, k, v, causal: bool, scale: float):
    """K4: (o, lse) for what K1 does not take. The kernel for CUDA
    tensors, the plain version otherwise."""
    if not _build.on_card(q):
        return mha_reference_with_lse(q, k, v, causal=causal, scale=scale)
    _check(q, k, v, general=True)
    b, h, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    _build.launch(_GENERAL, "flash_fwd_general", q.device, q, k, v, o, lse,
                  b, h, sq, k.shape[2], d, int(causal), float(scale),
                  _DTYPE_CODE[q.dtype])
    return o, lse


def flash_bwd_dkdv_general(q, k, v, do, lse, delta, causal: bool,
                           scale: float):
    """K5: (dk, dv) for what K2 does not take. The kernel for CUDA
    tensors, the plain version otherwise."""
    if not _build.on_card(q):
        return flash_bwd_dkdv_reference(q, k, v, do, lse, delta, causal,
                                        scale)
    _check(q, k, v, do, general=True)
    b, h, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.launch(_GENERAL, "flash_bwd_dkdv_general", q.device, q, k, v, do,
                  _stats(lse, q), _stats(delta, q), dk, dv, b, h, sq,
                  k.shape[2], d, int(causal), float(scale),
                  _DTYPE_CODE[q.dtype])
    return dk, dv


def flash_bwd_dq_general(q, k, v, do, lse, delta, causal: bool,
                         scale: float):
    """K6: dq for what K3 does not take. The kernel for CUDA tensors, the
    plain version otherwise."""
    if not _build.on_card(q):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale)
    _check(q, k, v, do, general=True)
    b, h, sq, d = q.shape
    dq = torch.empty_like(q)
    _build.launch(_GENERAL, "flash_bwd_dq_general", q.device, q, k, v, do,
                  _stats(lse, q), _stats(delta, q), dq, b, h, sq, k.shape[2],
                  d, int(causal), float(scale), _DTYPE_CODE[q.dtype])
    return dq


KERNEL_WRAPPERS = (flash_fwd, flash_bwd_dkdv, flash_bwd_dq)
GENERAL_WRAPPERS = (flash_fwd_general, flash_bwd_dkdv_general,
                    flash_bwd_dq_general)


def kernels_for(dtype: torch.dtype, head_dim: int):
    """(forward, dk/dv, dq) wrappers for this input: the Hopper kernels
    where they take it (``hopper_takes``), the general ones otherwise."""
    return (KERNEL_WRAPPERS if hopper_takes(dtype, head_dim)
            else GENERAL_WRAPPERS)


# ---------------------------------------------------------------------------
# Differentiable flash attention: kernel forward, kernel backward.
# ---------------------------------------------------------------------------

class _Flash(torch.autograd.Function):
    """Counterpart of ``_flash`` with ``_flash_fwd_rule``/``_flash_bwd_rule``:
    saves q, k, v, o and lse; the backward computes delta = rowsum(dO o)
    in fp32 and runs the dk/dv and dq kernels of ``kernels_for``.

    Each call is a device span (``attn.forward``, ``attn.backward``, with
    the call's q shape). The backward joins the forward's trace by the id
    the forward keeps: on a card it runs on autograd's worker thread."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        with tracing.device_span("attn.forward", q) as span:
            ctx.trace = None
            if span is not None:
                span.attributes["shape"] = tuple(q.shape)
                ctx.trace = span.trace_id
            fwd, ctx.dkdv, ctx.dq = kernels_for(q.dtype, q.shape[-1])
            o, lse = fwd(q, k, v, causal, scale)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        with tracing.device_span("attn.backward", do, ctx.trace) as span:
            q, k, v, o, lse = ctx.saved_tensors
            if span is not None:
                span.attributes["shape"] = tuple(q.shape)
            do = do.contiguous()
            delta = (do.float() * o.float()).sum(dim=-1)
            dk, dv = ctx.dkdv(q, k, v, do, lse, delta, ctx.causal,
                              ctx.scale)
            dq = ctx.dq(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """Flash attention, differentiable. q/k/v: [batch, heads, seq, dim]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _Flash.apply(q, k, v, causal, scale)


def attention(q, k, v, causal: bool = True, impl: str = "auto",
              scale: Optional[float] = None):
    """Dispatch: 'flash' | 'auto' (the kernels for CUDA tensors, their
    plain versions off the card) | 'reference' (plain autograd attention)."""
    if impl == "reference":
        return mha_reference(q, k, v, causal=causal, scale=scale)
    if impl not in ("auto", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    return flash_attention(q, k, v, causal=causal, scale=scale)


def attention_with_lse(q, k, v, causal: bool = True,
                       scale: Optional[float] = None, impl: str = "auto"):
    """Forward-only attention returning (o, lse): the forward kernel of
    ``kernels_for``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "reference":
        return mha_reference_with_lse(q, k, v, causal=causal, scale=scale)
    if impl not in ("auto", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    return kernels_for(q.dtype, q.shape[-1])[0](q, k, v, causal, scale)
