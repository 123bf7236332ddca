"""LayerNorm: a hand-written CUDA kernel forward and one backward, with the
plain version beside them.

``layer_norm`` normalises the last dimension of x in fp32 (population
variance) and returns x's dtype. For a CUDA tensor that is not a DTensor
it runs ``_LayerNorm``: the forward kernel ``layer_norm_fwd`` and, through
autograd, the backward kernel ``layer_norm_bwd`` (csrc/layer_norm.cu), or
raises; nothing falls back. For the rest, a tensor off the card or a
DTensor (``build_sharded_train`` outside an ``smap`` region), it runs the
plain version, ``layer_norm_reference``, the composite the models have
always used.

The kernels replace no TPU kernel (XLA fuses the JAX package's norm). They
are bound by bytes; the source says how they move each byte once. Threads
a row and the vector width are chosen from the width and the dtype
(``_plan``): 16-byte loads where d and every pointer allow, else element
by element, and as many warps a row as the row's elements need. Widths up
to ``MAX_WIDTH``.

Each call is counted on the trace it runs in (``tracing.count``, onto the
trace's outermost open span, such as ``train.step``): a kernel call forward
and one backward add to ``norm_kernel_calls``, a call of the plain version
to ``norm_plain_calls``; the first count puts both attributes on the span.
The backward, on autograd's thread on a card, counts into the trace its
forward kept. Launches are counted as every kernel's are
(``_build.launch_counts``: ``layer_norm_fwd`` and ``layer_norm_bwd``, one a
call; a backward call launches the rows kernel and the column sums).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from ..observability import tracing
from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRIES = {"layer_norm": {
    "layer_norm_fwd": [_P] * 6 + [_I] * 4 + [_F, _I, _I, _P],
    "layer_norm_bwd": [_P] * 9 + [_I] * 7 + [_P],
}}
_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# What one call adds to its trace's counts.
_KERNEL_CALL = {"norm_kernel_calls": 1, "norm_plain_calls": 0}
_PLAIN_CALL = {"norm_kernel_calls": 0, "norm_plain_calls": 1}
# As csrc/layer_norm.cu: threads a block, elements of x a thread holds
# forward and backward, and the backward's resident blocks an SM (its
# __launch_bounds__).
MAX_THREADS, FWD_ELEMS, BWD_ELEMS, BWD_BLOCKS_PER_SM = 256, 64, 16, 2
MAX_WIDTH = BWD_ELEMS * MAX_THREADS


def layer_norm_reference(x, scale, bias, eps: float = 1e-5):
    """LayerNorm in fp32 (population variance), returned in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _plan(d: int, dtype: torch.dtype, elems: int, rows_tensors,
          param_tensors) -> Tuple[int, int]:
    """(vec, row_threads): 16 bytes' worth of elements a load where d and
    every pointer allow, else 1; whole warps a row, enough for ``elems``
    elements a thread."""
    vec = 16 // dtype.itemsize
    if (d % vec or any(t.data_ptr() % 16 for t in rows_tensors)
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


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over x's last dimension in fp32, returned in x's dtype:
    the kernels for CUDA tensors, the plain version for the rest (tensors
    off the card, DTensors). Scale and bias of another dtype than x's or
    fp32 go to the kernels in fp32."""
    if not _takes_kernels(x, scale, bias):
        tracing.count(_PLAIN_CALL)
        return layer_norm_reference(x, scale, bias, eps)
    if scale.dtype not in (x.dtype, torch.float32) or bias.dtype != \
            scale.dtype:
        scale, bias = scale.float(), bias.float()
    return _LayerNorm.apply(x, scale, bias, eps)

