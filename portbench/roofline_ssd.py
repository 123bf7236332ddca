"""Operations and bytes of one call of the Mamba-2 state-space scan (SSD),
chunked, forward and backward: the least work the call asks for, so that
its share of the roofline (``roofline.bound_s`` over its device time)
cannot pass 100%.

The call: x ``[b, S, h, p]``, dt ``[b, S, h]``, A ``[h]``, B and C ``[b, S,
n]`` (one group) in, y ``[b, S, h, p]`` out. At chunk Q, each chunk of L
positions (Q, the last one possibly fewer) costs, with T = L (L + 1) / 2
(the causal half with its diagonal, counted once):

- C B^T within the chunk: 2 b T n (shared by the heads);
- the quadratic form's product with dt x: 2 b h T p;
- the chunk's end state: 2 b h L p n;
- carrying the state across the chunk: 2 b h p n;
- the state's contribution to y: 2 b h L p n.

The backward takes the gradient of each product with respect to both
operands, twice the forward's operations. Bytes: each input read once and
each output written once, forward x, dt, B, C, A in and y out; backward x,
dt, B, C, A and dy in, dx, ddt, dB, dC and dA out. ``elem`` is the bytes of
x, B and C (and of their gradients), ``dt_bytes`` of dt, A and theirs,
``y_bytes`` of y and dy.
"""

from __future__ import annotations

from typing import Dict


def ssd_call(b: int, s: int, h: int, p: int, n: int, chunk: int,
             elem: int = 2, dt_bytes: int = 4, y_bytes: int = 4
             ) -> Dict[str, Dict[str, float]]:
    full, last = divmod(s, chunk)
    lengths = [chunk] * full + ([last] if last else [])
    flops = 0.0
    for L in lengths:
        t = L * (L + 1) // 2
        flops += 2.0 * b * t * n + 2.0 * b * h * t * p \
            + 4.0 * b * h * L * p * n + 2.0 * b * h * p * n
    x = b * s * h * p * elem
    bc = 2 * b * s * n * elem
    dt = b * s * h * dt_bytes + h * dt_bytes
    y = b * s * h * p * y_bytes
    return {"fwd": {"flops": flops, "bytes": float(x + bc + dt + y)},
            "bwd": {"flops": 2.0 * flops,
                    "bytes": float(2 * (x + bc + dt) + y)}}
