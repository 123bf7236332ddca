"""The Mamba-2 state-space scan (SSD), chunked: hand-written CUDA kernels
for CUDA tensors, plain PyTorch ops for the rest.

For each batch row and head, with ``a_t = dt_t A``::

    y_t = sum_{s <= t} (C_t . B_s) exp(a_{s+1} + ... + a_t) dt_s x_s

(the skip ``D x_t`` is the caller's). Shapes: x ``[b, S, h, p]``, dt
``[b, S, h]`` (positive: after the softplus), A ``[h]`` (negative), B and C
``[b, S, n]`` (one group, shared by every head); y ``[b, S, h, p]`` fp32.

The sequence is cut into chunks of ``chunk`` positions (the last padded
with dt = 0, which neither decays nor adds), as ``torch_forward`` of the
Mamba-2 mixer in ``transformers`` cuts it: within a chunk the quadratic
form, masked causally; across chunks each chunk's end state, carried by the
chunks' total decays; each position reads the state that enters its chunk.
Within a chunk the decay ``exp(cs_t - cs_s)`` is a difference of
cumulative sums, as mamba_ssm's chunk kernels take it.

``ssd`` runs, for a CUDA tensor, ``_KernelSSD``: the kernels of
``csrc/ssd_state.cu``, ``csrc/ssd_scan.cu`` and ``csrc/ssd_grad.cu`` (the
design is in ``csrc/ssd.cuh``), or raises; nothing falls back. They take
x, B and C in bf16 (x's heads contiguous, a position's row at any stride
that is a multiple of 8, as the mixer's split leaves them), dt and A in
fp32, and the (p, n, chunk) of ``KERNEL_SHAPES`` only. What crosses
chunks is each chunk's fp32 ``[p, n]`` state a head; nothing of size
chunk x chunk a head is kept or written, and the forward keeps nothing
but its inputs for the backward. Launches are counted on each kernel's
wrapper (``chunk_state.launches``, ...; ``counts``, ``reset_counts``).

Any other tensor takes ``_SSD``, the plain version (``ssd_reference`` on
any device): everything fp32, its forward and its backward each over
blocks of heads sized so that a block's ``[b, heads, chunks, chunk,
chunk]`` temporaries stay near ``BLOCK_BYTES``; the backward recomputes a
block's forward and takes its gradients, so nothing of the quadratic form
is kept between the two. Across chunks its sums are taken segment by
segment (``_segsum``), as the source does.

Both are device spans (``ssm.forward``, ``ssm.backward``, with the call's
``shape`` (b, S, h, p, n), ``chunk`` and ``impl``, "kernel" or "plain");
the forward nests under the thread's current span, and the backward, on
autograd's thread, joins the forward's trace by the id the forward keeps.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..observability import tracing
from . import _build

BLOCK_BYTES = 1 << 30
# (p, n, chunk) the kernels are built for: the Mamba-2 configurations'
# (granite-4.0-h-small: 64, 128, 256) and a small one for the card tests.
KERNEL_SHAPES = ((64, 128, 256), (32, 16, 64))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """``[..., T] -> [..., T, T]``: entry (t, s) the sum of ``a`` over
    s+1..t for s <= t, summed segment by segment; -inf above the
    diagonal."""
    t = a.shape[-1]
    below = torch.ones(t, t, dtype=torch.bool, device=a.device).tril_(-1)
    out = a[..., None].expand(*a.shape, t).masked_fill(~below, 0.0)
    out = torch.cumsum(out, dim=-2)
    return out.masked_fill(~below.fill_diagonal_(True), float("-inf"))


def _chunk_scan(x, dt, A, B, C, G):
    """One block of heads on chunked inputs: x ``[b, c, Q, h, p]``, dt
    ``[b, c, Q, h]``, A ``[h]``, B and C ``[b, c, Q, n]``, G = C B^T ``[b, c,
    Q, Q]``, all fp32 -> y ``[b, c, Q, h, p]``."""
    q = x.shape[2]
    cs = torch.cumsum((dt * A).permute(0, 3, 1, 2), dim=-1)  # [b, h, c, Q]
    xd = (x * dt[..., None]).permute(0, 3, 1, 2, 4)          # [b, h, c, Q, p]
    # Within a chunk: (C_t . B_s) exp(cs_t - cs_s) for s <= t, times dt x.
    above = torch.ones(q, q, dtype=torch.bool, device=x.device).triu_(1)
    decay = (cs[..., :, None] - cs[..., None, :]).masked_fill_(
        above, float("-inf")).exp_()
    y = (decay * G[:, None]) @ xd
    del decay
    # Each chunk's end state [p, n], then the state entering each chunk.
    to_end = torch.exp(cs[..., -1:] - cs)
    states = (xd * to_end[..., None]).transpose(-1, -2) @ B[:, None]
    states = F.pad(states, (0, 0, 0, 0, 1, 0))               # [b, h, c+1, p, n]
    carry = torch.exp(_segsum(F.pad(cs[..., -1], (1, 0))))   # [b, h, c+1, c+1]
    entering = (carry @ states.flatten(-2))[:, :, :-1].unflatten(
        -1, states.shape[-2:])                               # [b, h, c, p, n]
    y = y + torch.exp(cs)[..., None] * (C[:, None] @ entering.transpose(-1,
                                                                        -2))
    return y.permute(0, 2, 3, 1, 4)


def _chunked(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """``[b, S, ...] -> [b, c, chunk, ...]``, zero-padded to whole chunks."""
    pad = (-t.shape[1]) % chunk
    if pad:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.unflatten(1, (-1, chunk))


def _head_block(x: torch.Tensor, chunk: int) -> int:
    b, s, h = x.shape[:3]
    per_head = b * -(-s // chunk) * chunk * chunk * 4
    return max(1, min(h, BLOCK_BYTES // per_head))


def _describe(span, x, B, chunk: int, impl: str):
    """Puts the call's shape, chunk and path on ``span`` (None: inactive);
    returns its trace id for the backward."""
    if span is None:
        return None
    span.attributes["shape"] = (*x.shape, B.shape[-1])
    span.attributes["chunk"] = chunk
    span.attributes["impl"] = impl
    return span.trace_id


class _SSD(torch.autograd.Function):
    """The plain version."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        with tracing.device_span("ssm.forward", x) as span:
            ctx.trace = _describe(span, x, B, chunk, "plain")
            b, s, h, p = x.shape
            xc, dtc = _chunked(x, chunk), _chunked(dt.float(), chunk)
            Bc, Cc = _chunked(B.float(), chunk), _chunked(C.float(), chunk)
            G = Cc @ Bc.transpose(-1, -2)
            y = torch.empty(*xc.shape, dtype=torch.float32, device=x.device)
            hb = _head_block(x, chunk)
            for h0 in range(0, h, hb):
                blk = slice(h0, h0 + hb)
                y[..., blk, :] = _chunk_scan(xc[..., blk, :].float(),
                                             dtc[..., blk], A[blk].float(),
                                             Bc, Cc, G)
            ctx.save_for_backward(x, dt, A, B, C)
            ctx.chunk = chunk
        return y.flatten(1, 2)[:, :s]

    @staticmethod
    def backward(ctx, dy):
        with tracing.device_span("ssm.backward", dy, ctx.trace) as span:
            x, dt, A, B, C = ctx.saved_tensors
            chunk = ctx.chunk
            _describe(span, x, B, chunk, "plain")
            b, s, h, p = x.shape
            xc, dtc = _chunked(x, chunk), _chunked(dt.float(), chunk)
            dyc = _chunked(dy.float(), chunk)
            dx = torch.empty(xc.shape, dtype=x.dtype, device=x.device)
            ddt = torch.empty(dtc.shape, dtype=torch.float32,
                              device=x.device)
            dA = torch.empty(h, dtype=torch.float32, device=x.device)
            with torch.enable_grad():
                Bc = _chunked(B.detach().float(), chunk).requires_grad_()
                Cc = _chunked(C.detach().float(), chunk).requires_grad_()
                G = Cc @ Bc.transpose(-1, -2)
                Gl = G.detach().requires_grad_()
                dB = torch.zeros_like(Bc)
                dC = torch.zeros_like(Cc)
                dG = torch.zeros_like(G)
                hb = _head_block(x, chunk)
                for h0 in range(0, h, hb):
                    blk = slice(h0, h0 + hb)
                    xb = xc[..., blk, :].float().requires_grad_()
                    dtb = dtc[..., blk].detach().requires_grad_()
                    Ab = A[blk].detach().float().requires_grad_()
                    y = _chunk_scan(xb, dtb, Ab, Bc, Cc, Gl)
                    gx, gdt, gA, gB, gC, gG = torch.autograd.grad(
                        y, (xb, dtb, Ab, Bc, Cc, Gl), dyc[..., blk, :])
                    del y
                    dx[..., blk, :] = gx
                    ddt[..., blk] = gdt
                    dA[blk] = gA
                    dB += gB
                    dC += gC
                    dG += gG
                gB, gC = torch.autograd.grad(G, (Bc, Cc), dG)
            dB, dC = dB + gB, dC + gC
        unpad = lambda t, like: t.flatten(1, 2)[:, :s].to(like.dtype)  # noqa: E731
        return (unpad(dx, x), unpad(ddt, dt), dA.to(A.dtype), unpad(dB, B),
                unpad(dC, C), None)


# -- the kernels --------------------------------------------------------------

_LIBS = {"ssd_state": "ssd_state_launch", "ssd_scan": "ssd_scan_launch",
         "ssd_grad": "ssd_grad_launch"}
# The entry points' pointers, in order (csrc/ssd.cuh, RTT_SSD_ARGS).
_FIELDS = ("x", "B", "C", "dt", "A", "dy", "cs", "st", "ent", "y", "ddec",
           "dx", "ddt", "dA", "dG", "out", "G")
_I, _P, _L = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = [_I, _I] + [_P] * len(_FIELDS) + [_L, _L] + [_I] * 7 + [_P]
# Elements of a (head, batch row)'s states a state_pass block takes.
PASS_SLICE = 512


def _launch(lib: str, kernel: int, mode: int, t: Dict[str, torch.Tensor],
            x: torch.Tensor, B: torch.Tensor, chunk: int) -> None:
    """One launch of a kernel of library ``lib`` on x's device's current
    stream: the tensors ``t`` by field name (missing ones NULL), the shapes
    and strides from x and B."""
    if not _build.has_library(lib):
        _build.build(list(_LIBS))  # all three at once, on the first call
    fn = getattr(_build.load(lib, {_LIBS[lib]: _ARGTYPES}), _LIBS[lib])
    b, s, h, p = x.shape
    n = B.shape[-1]
    parts = t["ddec"].shape[-1] if "ddec" in t else 0
    ptrs = [t[f].data_ptr() if f in t else None for f in _FIELDS]
    if x.device.type == "cuda":
        with torch.cuda.device(x.device):
            err = fn(kernel, mode, *ptrs, x.stride(1), B.stride(1), b, s, h,
                     p, n, chunk, parts,
                     torch.cuda.current_stream(x.device).cuda_stream)
    else:  # a host build of the sources (the tests')
        err = fn(kernel, mode, *ptrs, x.stride(1), B.stride(1), b, s, h, p,
                 n, chunk, parts, None)
    if err != 0:
        raise RuntimeError(f"{lib} kernel {kernel} launch failed: "
                           f"cudaError {err}")


def chunk_state(fwd: bool, t, x, B, chunk) -> None:
    """Forward: the chunks' cumulative sums ``cs`` and states ``st``;
    backward: each chunk's dy term of its entering state's gradient."""
    _launch("ssd_state", 0, int(fwd), t, x, B, chunk)
    chunk_state.launches += 1


def state_pass(fwd: bool, t, x, B, chunk) -> None:
    """In place over ``st``: the states entering each chunk (forward), the
    gradients of the states leaving each chunk and ``ddec`` (backward)."""
    _launch("ssd_state", 1, int(fwd), t, x, B, chunk)
    state_pass.launches += 1


def chunk_scan(fwd: bool, t, x, B, chunk) -> None:
    """Forward: y. Backward: dx, ddt and dA's part of each chunk."""
    _launch("ssd_scan", 0, int(fwd), t, x, B, chunk)
    chunk_scan.launches += 1


def chunk_dg(t, x, B, chunk) -> None:
    """The gradient of each chunk's C B^T, summed over the heads."""
    _launch("ssd_grad", 0, 0, t, x, B, chunk)
    chunk_dg.launches += 1


def chunk_bc(dc: bool, t, x, B, chunk) -> None:
    """The state terms of dC (``dc``) or of dB, summed over the heads."""
    _launch("ssd_grad", 1, int(dc), t, x, B, chunk)
    chunk_bc.launches += 1


KERNEL_WRAPPERS = (chunk_state, state_pass, chunk_scan, chunk_dg, chunk_bc)


def check_kernel_inputs(x, dt, A, B, C, chunk: int) -> None:
    """Raises unless the kernels take these inputs: all on one CUDA device,
    and ``check_kernel_layout``."""
    ts = dict(x=x, dt=dt, A=A, B=B, C=C)
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in ts.values()):
        raise ValueError(f"the scan's kernels run on one CUDA device, got "
                         f"{ {k: str(t.device) for k, t in ts.items()} }")
    check_kernel_layout(x, dt, A, B, C, chunk)


def check_kernel_layout(x, dt, A, B, C, chunk: int) -> None:
    """Raises unless the kernels take these types, shapes, strides and
    alignments (module docstring), whatever the device."""
    ts = dict(x=x, dt=dt, A=A, B=B, C=C)
    want = dict(x=torch.bfloat16, B=torch.bfloat16, C=torch.bfloat16,
                dt=torch.float32, A=torch.float32)
    got = {k: ts[k].dtype for k in want}
    if got != want:
        raise TypeError(f"the scan's kernels take {want}, got {got}")
    if x.dim() != 4 or B.dim() != 3:
        raise ValueError(f"x must be [b, S, h, p] and B [b, S, n], got "
                         f"{tuple(x.shape)} and {tuple(B.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if (dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, n)
            or C.shape != B.shape):
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)} do not fit")
    if (p, n, chunk) not in KERNEL_SHAPES:
        raise ValueError(f"the scan's kernels are built for (p, n, chunk) in "
                         f"{KERNEL_SHAPES}, got {(p, n, chunk)}")
    if s < 1 or b < 1 or h < 1:
        raise ValueError(f"empty scan {tuple(x.shape)}")
    xs, bs = x.stride(1), B.stride(1)
    if (x.stride(3) != 1 or x.stride(2) != p or xs % 8
            or (b > 1 and x.stride(0) != s * xs)):
        raise ValueError(f"x's heads must be contiguous and its positions at "
                         f"a stride that is a multiple of 8, got strides "
                         f"{x.stride()}")
    if (B.stride() != C.stride() or B.stride(2) != 1 or bs % 8
            or (b > 1 and B.stride(0) != s * bs)):
        raise ValueError(f"B and C must be rows of n at one stride that is a "
                         f"multiple of 8, got {B.stride()} and {C.stride()}")
    if not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("dt and A must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("x, B and C must start on 16 bytes")


def _chunk_products(U, V, chunk: int) -> torch.Tensor:
    """U V^T within each chunk, fp32 ``[b, chunks, chunk, chunk]``: one
    plain product a (batch row, chunk), shared by the heads."""
    Uc, Vc = _chunked(U.float(), chunk), _chunked(V.float(), chunk)
    return Uc @ Vc.transpose(-1, -2)


def ssd_kernel_forward(x, dt, A, B, C, chunk: int):
    """The forward kernels: (y, cs, entering states)."""
    b, s, h, p = x.shape
    n, c = B.shape[-1], -(-s // chunk)
    f32 = dict(device=x.device, dtype=torch.float32)
    cs = torch.empty(b, h, c, chunk, **f32)
    st = torch.empty(b, h, c, p, n, **f32)
    y = torch.empty(b, s, h, p, **f32)
    t = dict(x=x, B=B, C=C, dt=dt, A=A, cs=cs, st=st, y=y,
             G=_chunk_products(C, B, chunk))
    chunk_state(True, t, x, B, chunk)
    state_pass(True, t, x, B, chunk)
    chunk_scan(True, t, x, B, chunk)
    return y, cs, st


def ssd_kernel_backward(dy, x, dt, A, B, C, chunk: int):
    """The backward kernels, after the forward's chunk_state and state_pass
    again for cs and the entering states, then dC += dG B and dB += dG^T C
    by plain products: (dx, ddt, dA, dB, dC) in the inputs' types."""
    b, s, h, p = x.shape
    n, c = B.shape[-1], -(-s // chunk)
    f32 = dict(device=x.device, dtype=torch.float32)
    cs = torch.empty(b, h, c, chunk, **f32)
    ent = torch.empty(b, h, c, p, n, **f32)
    fwd = dict(x=x, B=B, C=C, dt=dt, A=A, cs=cs, st=ent)
    chunk_state(True, fwd, x, B, chunk)
    state_pass(True, fwd, x, B, chunk)
    dy = dy.float().contiguous()
    st = torch.empty(b, h, c, p, n, **f32)
    ddec = torch.empty(b, h, c, p * n // PASS_SLICE, **f32)
    dx = torch.empty(b, s, h, p, device=x.device, dtype=x.dtype)
    ddt = torch.empty(b, s, h, **f32)
    dA = torch.empty(b, h, c, **f32)
    dG = torch.zeros(b, c, chunk, chunk, **f32)
    dc = torch.empty(b, c * chunk, n, **f32)
    db = torch.empty(b, c * chunk, n, **f32)
    t = dict(x=x, B=B, C=C, dt=dt, A=A, dy=dy, cs=cs, st=st, ent=ent,
             ddec=ddec, dx=dx, ddt=ddt, dA=dA, dG=dG,
             G=_chunk_products(B, C, chunk))
    chunk_state(False, t, x, B, chunk)
    state_pass(False, t, x, B, chunk)
    chunk_scan(False, t, x, B, chunk)
    del t["G"]
    chunk_bc(True, dict(t, out=dc), x, B, chunk)
    del t["ent"], ent  # its last reader
    chunk_bc(False, dict(t, out=db), x, B, chunk)
    chunk_dg(t, x, B, chunk)
    Bc, Cc = _chunked(B.float(), chunk), _chunked(C.float(), chunk)
    dc = torch.baddbmm(dc.view(b * c, chunk, n), dG.view(b * c, chunk, chunk),
                       Bc.view(b * c, chunk, n))
    db = torch.baddbmm(db.view(b * c, chunk, n),
                       dG.view(b * c, chunk, chunk).transpose(1, 2),
                       Cc.view(b * c, chunk, n))
    unpad = lambda t: t.view(b, c * chunk, n)[:, :s].to(B.dtype)  # noqa: E731
    return dx, ddt, dA.sum((0, 2)), unpad(db), unpad(dc)


class _KernelSSD(torch.autograd.Function):
    """The kernels forward and backward. Nothing is kept but the inputs:
    the backward makes the entering states again (~4 ms at the Granite
    cell's shape), where keeping them (1.07 GB a layer) would hold them
    through the rest of the layer's recompute and backward."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        with tracing.device_span("ssm.forward", x) as span:
            ctx.trace = _describe(span, x, B, chunk, "kernel")
            y, _, _ = ssd_kernel_forward(x, dt, A, B, C, chunk)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, dt, A, B, C = ctx.saved_tensors
        with tracing.device_span("ssm.backward", dy, ctx.trace) as span:
            _describe(span, x, B, ctx.chunk, "kernel")
            grads = ssd_kernel_backward(dy, x, dt, A, B, C, ctx.chunk)
        return (*grads, None)


def ssd(x, dt, A, B, C, chunk: int = 256):
    """The chunked scan, differentiable in every input (module docstring):
    the kernels for CUDA tensors, the plain version for the rest."""
    if B.dim() != 3 or C.shape != B.shape:
        raise ValueError(f"B and C must be [b, S, n] (one group), got "
                         f"{tuple(B.shape)} and {tuple(C.shape)}")
    if x.device.type == "cuda":
        check_kernel_inputs(x, dt, A, B, C, chunk)
        return _KernelSSD.apply(x, dt, A, B, C, chunk)
    return _SSD.apply(x, dt, A, B, C, chunk)


def ssd_reference(x, dt, A, B, C, chunk: int = 256):
    """The plain version on any device, as the CPU takes it."""
    if B.dim() != 3 or C.shape != B.shape:
        raise ValueError(f"B and C must be [b, S, n] (one group), got "
                         f"{tuple(B.shape)} and {tuple(C.shape)}")
    return _SSD.apply(x, dt, A, B, C, chunk)


def counts() -> Dict[str, int]:
    """Launches of each kernel since ``reset_counts``."""
    return {f.__name__: f.launches for f in KERNEL_WRAPPERS}


def reset_counts() -> None:
    for f in KERNEL_WRAPPERS:
        f.launches = 0


reset_counts()
