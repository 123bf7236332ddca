"""LayerNorm and RMSNorm: hand-written CUDA kernels, one forward and one
backward each, with the plain versions beside them.

``layer_norm`` normalises the last dimension of x in fp32 (population
variance) and returns x's dtype. ``rms_norm`` scales it by the inverse root
of its mean square in fp32 and returns x's dtype. ``gated_rms_norm`` is
Mamba-2's gated form with its skip: u = (y + D[head] x) silu(z), normalised
so in fp32 and returned in z's dtype. For CUDA tensors none of which is a
DTensor each runs its kernels through an autograd function (LayerNorm:
``layer_norm_fwd`` and ``layer_norm_bwd``, csrc/layer_norm.cu; RMSNorm, both
forms: ``rms_norm_fwd``/``rms_norm_bwd`` and ``gated_rms_norm_fwd``/
``gated_rms_norm_bwd``, csrc/rms_norm.cu), or raises; nothing falls back.
For the rest, tensors off the card or DTensors (``build_sharded_train``
outside an ``smap`` region), each runs its plain version
(``layer_norm_reference``, ``rms_norm_reference``,
``gated_rms_norm_reference``), the composites the models have always used.

The kernels replace no TPU kernel (XLA fuses the JAX package's norms).
They are bound by bytes; the sources say how they move each byte once.
Threads a row and the vector width are chosen from the width, the dtype
and the alignment (``_plan``): 16-byte loads where d and every pointer and
row stride allow, else element by element, and as many warps a row as the
row's elements need. Widths up to ``MAX_WIDTH`` (LayerNorm) and
``RMS_MAX_WIDTH`` (RMSNorm).

Each call is counted on the trace it runs in (``tracing.count``, onto the
trace's outermost open span, such as ``train.step``): a LayerNorm kernel
call forward and one backward add to ``norm_kernel_calls``, a call of its
plain version to ``norm_plain_calls``; an RMSNorm call of either form to
``rms_norm_kernel_calls`` or ``rms_norm_plain_calls``. The first count puts
both attributes of the pair on the span. A backward, on autograd's thread
on a card, counts into the trace its forward kept. Launches are counted as
every kernel's are (``_build.launch_counts``: one of each entry point a
call; a backward call launches the rows kernel and the column sums).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..observability import tracing
from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRIES = {"layer_norm": {
    "layer_norm_fwd": [_P] * 6 + [_I] * 4 + [_F, _I, _I, _P],
    "layer_norm_bwd": [_P] * 9 + [_I] * 7 + [_P],
}}
_RMS_ENTRIES = {"rms_norm": {
    "rms_norm_fwd": [_P] * 4 + [_I] * 4 + [_F, _I, _I, _P],
    "rms_norm_bwd": [_P] * 7 + [_I] * 7 + [_P],
    "gated_rms_norm_fwd": [_P] * 7 + [_I] * 7 + [_F, _I, _I, _P],
    "gated_rms_norm_bwd": [_P] * 13 + [_I] * 10 + [_P],
}}
_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# What one call adds to its trace's counts.
_KERNEL_CALL = {"norm_kernel_calls": 1, "norm_plain_calls": 0}
_PLAIN_CALL = {"norm_kernel_calls": 0, "norm_plain_calls": 1}
_RMS_KERNEL_CALL = {"rms_norm_kernel_calls": 1, "rms_norm_plain_calls": 0}
_RMS_PLAIN_CALL = {"rms_norm_kernel_calls": 0, "rms_norm_plain_calls": 1}
# As csrc/layer_norm.cu: threads a block, elements of x a thread holds
# forward and backward, and the backward's resident blocks an SM (its
# __launch_bounds__).
MAX_THREADS, FWD_ELEMS, BWD_ELEMS, BWD_BLOCKS_PER_SM = 256, 64, 16, 2
MAX_WIDTH = BWD_ELEMS * MAX_THREADS
# As csrc/rms_norm.cu: threads a block and elements of a row a thread
# holds, forward and backward; the backward's resident blocks an SM.
RMS_FWD_THREADS, RMS_FWD_ELEMS = 512, 16
RMS_BWD_THREADS, RMS_BWD_ELEMS, RMS_BWD_BLOCKS_PER_SM = 512, 16, 1
RMS_MAX_WIDTH = min(RMS_FWD_THREADS * RMS_FWD_ELEMS,
                    RMS_BWD_THREADS * RMS_BWD_ELEMS)


def layer_norm_reference(x, scale, bias, eps: float = 1e-5):
    """LayerNorm in fp32 (population variance), returned in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rms_norm_reference(x, scale, eps: float = 1e-6):
    """RMSNorm in fp32, returned in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def gated_rms_norm_reference(y, x, D, z, scale, eps: float = 1e-6):
    """Mamba-2's gated RMSNorm with its skip, in fp32, returned in z's
    dtype: y and x [..., heads, p], D [heads], z and scale [..., heads p]."""
    u = (y + D.float()[:, None] * x.float()).flatten(-2) * F.silu(z.float())
    return rms_norm_reference(u, scale, eps).to(z.dtype)


def _plan(d: int, dtype: torch.dtype, elems: int, rows_tensors,
          param_tensors, aligned: bool = True) -> Tuple[int, int]:
    """(vec, row_threads): 16 bytes' worth of elements a load where d,
    every pointer and ``aligned`` (the caller's other conditions) allow,
    else 1; whole warps a row, enough for ``elems`` elements a thread."""
    vec = 16 // dtype.itemsize
    if (not aligned or d % vec
            or any(t.data_ptr() % 16 for t in rows_tensors)
            or any(t.data_ptr() % (vec * t.element_size())
                   for t in param_tensors)):
        vec = 1
    slots = elems // vec
    row_threads = 32 * -(-(d // vec) // (32 * slots))
    return vec, row_threads


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the LayerNorm kernels run on CUDA, got {x.device}")
    if x.dtype not in _CODE:
        raise TypeError(f"the LayerNorm kernels take fp32, bf16 or fp16, got"
                        f" {x.dtype}")
    if scale.dtype not in (x.dtype, torch.float32) or bias.dtype != \
            scale.dtype:
        raise TypeError(f"scale and bias must share x's dtype or fp32, got "
                        f"{scale.dtype} and {bias.dtype} for {x.dtype}")
    d = x.shape[-1]
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError("the LayerNorm kernels take contiguous [rows, d]")
    if not 1 <= d <= MAX_WIDTH:
        raise ValueError(f"the LayerNorm kernels take d 1 to {MAX_WIDTH}, "
                         f"got {d}")
    for t in (scale, bias):
        if t.shape != (d,) or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"scale and bias must be contiguous [{d}] on "
                             f"{x.device}")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def layer_norm_fwd(x, scale, bias, eps: float = 1e-5):
    """The forward kernel on x [rows, d]: (y in x's dtype, mean, rstd),
    the last two fp32 [rows]."""
    _check(x, scale, bias)
    rows, d = x.shape
    y = torch.empty_like(x)
    mean = torch.empty(rows, device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    if rows:
        vec, row_threads = _plan(d, x.dtype, FWD_ELEMS, (x, y),
                                 (scale, bias))
        _build.launch(_ENTRIES, "layer_norm_fwd", x.device, x, scale, bias,
                      y, mean, rstd, rows, d, row_threads, vec, float(eps),
                      _CODE[x.dtype], _CODE[scale.dtype])
    return y, mean, rstd


def layer_norm_bwd(dy, x, scale, mean, rstd):
    """The backward kernels on dy and x [rows, d]: (dx in x's dtype,
    dscale and dbias in scale's)."""
    _check(x, scale, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError("dy must be contiguous and match x")
    rows, d = x.shape
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    dbias = torch.empty_like(scale)
    if not rows:
        return dx, dscale.zero_(), dbias.zero_()
    vec, row_threads = _plan(d, x.dtype, BWD_ELEMS, (dy, x, dx), (scale,))
    groups = MAX_THREADS // row_threads
    blocks = min(-(-rows // groups),
                 BWD_BLOCKS_PER_SM * _sms(x.device.index))
    partial = torch.empty((2, blocks, d), device=x.device,
                          dtype=torch.float32)
    _build.launch(_ENTRIES, "layer_norm_bwd", x.device, dy, x, scale, mean,
                  rstd, dx, partial, dscale, dbias, rows, d, row_threads, vec,
                  blocks, _CODE[x.dtype], _CODE[scale.dtype])
    return dx, dscale, dbias


class _LayerNorm(torch.autograd.Function):
    """The forward kernel; saves x, scale, mean and rstd for the backward
    kernel, and the trace the forward counted into for the backward's
    count."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        ctx.trace = tracing.count(_KERNEL_CALL)
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).contiguous()
        y, mean, rstd = layer_norm_fwd(x2, scale, bias, eps)
        ctx.save_for_backward(x2, scale, mean, rstd)
        ctx.shape = shape
        return y.view(shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        if ctx.trace is not None:
            tracing.count(_KERNEL_CALL, ctx.trace)
        x2, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(
            dy.reshape(x2.shape).contiguous(), x2, scale, mean, rstd)
        return dx.view(ctx.shape), dscale, dbias, None


def _takes_kernels(*tensors) -> bool:
    """``_build.on_card``, except for DTensors (the one exception: they
    take the composite)."""
    if not _build.on_card(tensors[0]):
        return False
    from torch.distributed.tensor import DTensor

    return not any(isinstance(t, DTensor) for t in tensors)


def _common_params(x_dtype, *params):
    """The parameters as the kernels take them: as they are where they
    share one type, x's or fp32; else all in fp32."""
    if params[0].dtype in (x_dtype, torch.float32) and all(
            t.dtype == params[0].dtype for t in params):
        return params
    return tuple(t.float() for t in params)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over x's last dimension in fp32, returned in x's dtype:
    the kernels for CUDA tensors, the plain version for the rest (tensors
    off the card, DTensors). Scale and bias of another dtype than x's or
    fp32 go to the kernels in fp32."""
    if not _takes_kernels(x, scale, bias):
        tracing.count(_PLAIN_CALL)
        return layer_norm_reference(x, scale, bias, eps)
    return _LayerNorm.apply(x, *_common_params(x.dtype, scale, bias), eps)


def _rms_check(x: torch.Tensor, params) -> None:
    """x [rows, d] rows of unit stride on the card, in a type the kernels
    take, and each of ``params`` contiguous in x's type or fp32 (all in
    one) on x's device."""
    if not _build.on_card(x):
        raise ValueError(f"the RMSNorm kernels run on CUDA, got {x.device}")
    if x.dtype not in _CODE:
        raise TypeError(f"the RMSNorm kernels take fp32, bf16 or fp16, got "
                        f"{x.dtype}")
    d = x.shape[-1]
    if x.ndim != 2 or x.stride(-1) != 1:
        raise ValueError("the RMSNorm kernels take [rows, d] of unit stride")
    if not 1 <= d <= RMS_MAX_WIDTH:
        raise ValueError(f"the RMSNorm kernels take d 1 to {RMS_MAX_WIDTH}, "
                         f"got {d}")
    pdtype = params[0].dtype
    if pdtype not in (x.dtype, torch.float32) or any(
            t.dtype != pdtype for t in params):
        raise TypeError(f"the parameters must share x's dtype or fp32, got "
                        f"{[t.dtype for t in params]} for {x.dtype}")
    for t in params:
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"the parameters must be contiguous on "
                             f"{x.device}")


def _bwd_blocks(rows: int, row_threads: int, device) -> int:
    """The backward's grid: as many blocks as fit the card at once (each
    loops over its rows), fewer where there are fewer row groups."""
    groups = RMS_BWD_THREADS // row_threads
    return min(-(-rows // groups),
               RMS_BWD_BLOCKS_PER_SM * _sms(device.index))


def rms_norm_fwd(x, scale, eps: float = 1e-6):
    """The forward kernel on x [rows, d] contiguous: (out in x's dtype,
    rstd fp32 [rows])."""
    _rms_check(x, (scale,))
    if not x.is_contiguous() or scale.shape != x.shape[-1:]:
        raise ValueError("x must be contiguous and scale [d]")
    rows, d = x.shape
    out = torch.empty_like(x)
    rstd = torch.empty(rows, device=x.device, dtype=torch.float32)
    if rows:
        vec, row_threads = _plan(d, x.dtype, RMS_FWD_ELEMS, (x, out),
                                 (scale,))
        _build.launch(_RMS_ENTRIES, "rms_norm_fwd", x.device, x, scale, out,
                      rstd, rows, d, row_threads, vec, float(eps),
                      _CODE[x.dtype], _CODE[scale.dtype])
    return out, rstd


def rms_norm_bwd(dout, x, scale, rstd):
    """The backward kernels on dout and x [rows, d] contiguous: (dx in x's
    dtype, dscale in scale's)."""
    _rms_check(x, (scale,))
    if (dout.shape != x.shape or dout.dtype != x.dtype
            or not dout.is_contiguous() or not x.is_contiguous()):
        raise ValueError("dout and x must be contiguous and alike")
    rows, d = x.shape
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    if not rows:
        return dx, dscale.zero_()
    vec, row_threads = _plan(d, x.dtype, RMS_BWD_ELEMS, (dout, x, dx),
                             (scale,))
    blocks = _bwd_blocks(rows, row_threads, x.device)
    partial = torch.empty((blocks, d), device=x.device, dtype=torch.float32)
    _build.launch(_RMS_ENTRIES, "rms_norm_bwd", x.device, dout, x, scale,
                  rstd, dx, partial, dscale, rows, d, row_threads, vec,
                  blocks, _CODE[x.dtype], _CODE[scale.dtype])
    return dx, dscale


def _gated_args(y, x, D, z, scale):
    """Checks the gated form's operands, all [rows, d] but D; returns
    (head_dim, whether their layout takes 16-byte vectors)."""
    _rms_check(x, (scale, D))
    rows, d = x.shape
    if z.dtype != x.dtype or z.shape != x.shape or z.stride(-1) != 1:
        raise ValueError("z must be [rows, d] of unit stride in x's dtype")
    if y.dtype != torch.float32 or y.shape != x.shape or \
            not y.is_contiguous():
        raise ValueError("y must be contiguous fp32 [rows, d]")
    if scale.shape != (d,) or D.ndim != 1 or d % D.shape[0]:
        raise ValueError(f"scale must be [{d}] and D [heads] dividing {d}")
    head_dim = d // D.shape[0]
    vec = 16 // x.dtype.itemsize
    aligned = (head_dim % vec == 0 and y.data_ptr() % 16 == 0
               and all(t.stride(0) * t.element_size() % 16 == 0
                       for t in (x, z)))
    return head_dim, aligned


def gated_rms_norm_fwd(y, x, D, z, scale, eps: float = 1e-6):
    """The gated forward kernel on y fp32 [rows, d] contiguous, x and z
    [rows, d] at their row strides, D [heads] and scale [d]: (out in z's
    dtype, rstd fp32 [rows])."""
    head_dim, aligned = _gated_args(y, x, D, z, scale)
    rows, d = x.shape
    out = torch.empty((rows, d), device=x.device, dtype=x.dtype)
    rstd = torch.empty(rows, device=x.device, dtype=torch.float32)
    if rows:
        vec, row_threads = _plan(d, x.dtype, RMS_FWD_ELEMS, (x, z, out),
                                 (scale,), aligned)
        _build.launch(_RMS_ENTRIES, "gated_rms_norm_fwd", x.device, y, x, D,
                      z, scale, out, rstd, rows, d, head_dim, x.stride(0),
                      z.stride(0), row_threads, vec, float(eps),
                      _CODE[x.dtype], _CODE[scale.dtype])
    return out, rstd


def gated_rms_norm_bwd(dout, y, x, D, z, scale, rstd):
    """The gated backward kernels: (dy fp32, dx, dD, dz, dscale), dy, dx
    and dz contiguous [rows, d], dx and dz in x's dtype, dD and dscale in
    the parameters'."""
    head_dim, aligned = _gated_args(y, x, D, z, scale)
    if dout.shape != x.shape or dout.dtype != x.dtype or \
            not dout.is_contiguous():
        raise ValueError("dout must be contiguous and match x")
    rows, d = x.shape
    dy = torch.empty_like(y)
    dx = torch.empty((rows, d), device=x.device, dtype=x.dtype)
    dz = torch.empty_like(dx)
    dD = torch.empty_like(D)
    dscale = torch.empty_like(scale)
    if not rows:
        return dy, dx, dD.zero_(), dz, dscale.zero_()
    vec, row_threads = _plan(d, x.dtype, RMS_BWD_ELEMS,
                             (dout, x, z, dx, dz, dy), (scale,), aligned)
    blocks = _bwd_blocks(rows, row_threads, x.device)
    partial = torch.empty(blocks * (d + D.shape[0]), device=x.device,
                          dtype=torch.float32)
    _build.launch(_RMS_ENTRIES, "gated_rms_norm_bwd", x.device, dout, y, x,
                  D, z, scale, rstd, dy, dx, dz, partial, dD, dscale, rows,
                  d, head_dim, x.stride(0), z.stride(0), row_threads, vec,
                  blocks, _CODE[x.dtype], _CODE[scale.dtype])
    return dy, dx, dD, dz, dscale


class _RMSNorm(torch.autograd.Function):
    """The plain forward kernel; saves x, scale and rstd for the backward
    kernels, and the trace the forward counted into for the backward's
    count."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        ctx.trace = tracing.count(_RMS_KERNEL_CALL)
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        out, rstd = rms_norm_fwd(x2, scale, eps)
        ctx.save_for_backward(x2, scale, rstd)
        ctx.shape = x.shape
        return out.view(x.shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        if ctx.trace is not None:
            tracing.count(_RMS_KERNEL_CALL, ctx.trace)
        x2, scale, rstd = ctx.saved_tensors
        dx, dscale = rms_norm_bwd(dout.reshape(x2.shape).contiguous(), x2,
                                  scale, rstd)
        return dx.view(ctx.shape), dscale, None


class _GatedRMSNorm(torch.autograd.Function):
    """The gated forward kernel on [rows, d] views of its operands (x and z
    read in place); saves them and rstd for the backward kernels, which
    make u again."""

    @staticmethod
    def forward(ctx, y, x, D, z, scale, eps: float):
        ctx.trace = tracing.count(_RMS_KERNEL_CALL)
        # [rows, d] views where the leading dimensions merge (the mixer's
        # x and z, at their row strides), else contiguous copies.
        y2, x2, z2 = (t.reshape(-1, z.shape[-1]) for t in (y, x, z))
        out, rstd = gated_rms_norm_fwd(y2, x2, D, z2, scale, eps)
        ctx.save_for_backward(y2, x2, D, z2, scale, rstd)
        ctx.shapes = y.shape, x.shape, z.shape
        return out.view(z.shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        if ctx.trace is not None:
            tracing.count(_RMS_KERNEL_CALL, ctx.trace)
        y2, x2, D, z2, scale, rstd = ctx.saved_tensors
        dy, dx, dD, dz, dscale = gated_rms_norm_bwd(
            dout.reshape(z2.shape).contiguous(), y2, x2, D, z2, scale, rstd)
        ys, xs, zs = ctx.shapes
        return dy.view(ys), dx.view(xs), dD, dz.view(zs), dscale, None


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm over x's last dimension in fp32, returned in x's dtype: the
    kernels for CUDA tensors, the plain version for the rest (tensors off
    the card, DTensors). A scale of another dtype than x's or fp32 goes to
    the kernels in fp32."""
    if not _takes_kernels(x, scale):
        tracing.count(_RMS_PLAIN_CALL)
        return rms_norm_reference(x, scale, eps)
    return _RMSNorm.apply(x, *_common_params(x.dtype, scale), eps)


def gated_rms_norm(y, x, D, z, scale, eps: float = 1e-6):
    """Mamba-2's gated RMSNorm with its skip over the last dimension, in
    fp32, returned in z's dtype: ``rms_norm((y + D[:, None] x).flatten(-2)
    * silu(z), scale)`` with y fp32 and x [..., heads, p], D [heads], z
    [..., heads p] in x's dtype, scale [heads p]. The kernels for CUDA
    tensors (x and z read at their strides), the plain version for the
    rest. Parameters of two dtypes, or of one neither x's nor fp32, go to
    the kernels in fp32."""
    if not _takes_kernels(y, x, D, z, scale):
        tracing.count(_RMS_PLAIN_CALL)
        return gated_rms_norm_reference(y, x, D, z, scale, eps)
    D, scale = _common_params(x.dtype, D, scale)
    return _GatedRMSNorm.apply(y, x, D, z, scale, eps)
