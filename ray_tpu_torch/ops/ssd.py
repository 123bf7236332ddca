"""The Mamba-2 state-space scan (SSD), chunked, in plain PyTorch ops.

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
Everything is fp32. Within a chunk the decay ``exp(cs_t - cs_s)`` is a
difference of cumulative sums, as mamba_ssm's chunk kernels take it; across
chunks the sums are taken segment by segment (``_segsum``), as the source
does.

``ssd`` is one autograd Function. Its forward and its backward each work
over blocks of heads, sized so that a block's ``[b, heads, chunks, chunk,
chunk]`` temporaries stay near ``BLOCK_BYTES``; the backward recomputes a
block's forward and takes its gradients, so nothing of the quadratic form
is kept between the two. Each is a device span (``ssm.forward``,
``ssm.backward``, with the call's ``shape`` (b, S, h, p, n) and ``chunk``);
the forward nests under the thread's current span, and the backward, on
autograd's thread, joins the forward's trace by the id the forward keeps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..observability import tracing

BLOCK_BYTES = 1 << 30


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


class _SSD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        with tracing.device_span("ssm.forward", x) as span:
            ctx.trace = None
            if span is not None:
                span.attributes["shape"] = (*x.shape, B.shape[-1])
                span.attributes["chunk"] = chunk
                ctx.trace = span.trace_id
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
            if span is not None:
                span.attributes["shape"] = (*x.shape, B.shape[-1])
                span.attributes["chunk"] = chunk
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


def ssd(x, dt, A, B, C, chunk: int = 256):
    """The chunked scan, differentiable in every input (module
    docstring)."""
    if B.dim() != 3 or C.shape != B.shape:
        raise ValueError(f"B and C must be [b, S, n] (one group), got "
                         f"{tuple(B.shape)} and {tuple(C.shape)}")
    return _SSD.apply(x, dt, A, B, C, chunk)
