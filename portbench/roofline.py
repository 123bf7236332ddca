"""The yardstick's arithmetic: the cards' peaks, the operations a GPT-2
token costs, and the operations and bytes of one attention call.

Copied from ``chip_smoke.py`` (``PEAK_*``, ``causal_pairs``, ``bound``)
and from ``ray_tpu_torch/models/gpt2.py`` (``GPT2Config.num_params``,
``flops_per_token``), so that a change to the program cannot change what
it is measured against.
"""

from __future__ import annotations

from typing import Dict

# Published dense peaks by the name ``torch.cuda.get_device_name()`` gives
# (NVIDIA's H100 SXM data sheet, at the 700 W power limit). A card not in
# the table has no share of a peak reported.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "fp32_flops": 67e12,
                              "bytes": 3.35e12},
}


def gpt2_num_params(vocab: int, positions: int, layers: int, d: int,
                    mlp: int) -> int:
    """Every parameter of a GPT-2 with a tied head: token and position
    tables, per layer the QKV, projection and MLP weights, two layer norms
    and the biases, and the final layer norm."""
    per_layer = (4 * d * d + 2 * d * mlp  # qkv + proj, mlp in/out
                 + 2 * d * 2              # two layer norms
                 + 4 * d + mlp + d)       # qkv, proj, mlp biases
    return vocab * d + positions * d + layers * per_layer + 2 * d


def gpt2_flops_per_token(vocab: int, positions: int, layers: int, d: int,
                         mlp: int, seq: int) -> float:
    """Training operations a token: 6N plus the attention term 12 L d S
    (PaLM, appendix B). Recompute is not counted: it is not useful work."""
    n = gpt2_num_params(vocab, positions, layers, d, mlp)
    return 6.0 * n + 12.0 * layers * d * seq


def causal_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the mask keeps, absolute positions q >= k."""
    if not causal:
        return sq * sk
    if sq <= sk:
        return sq * (sq + 1) // 2
    return sk * (sk + 1) // 2 + (sq - sk) * sk


def attention_call(b: int, h: int, s: int, d: int, elem_bytes: int = 2
                   ) -> Dict[str, Dict[str, float]]:
    """Operations and bytes of one causal attention forward and of its
    backward at [b, h, s, d]. Each input is read once and each output
    written once. Forward: q, k, v in, o and the fp32 lse out; QK^T and PV.
    Backward: q, k, v, o, dO and lse in, dq, dk, dv out; the five products
    S = QK^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K."""
    pairs = b * h * causal_pairs(s, s, True)
    elem = b * h * s * d * elem_bytes
    stat = b * h * s * 4
    return {"fwd": {"flops": 4.0 * d * pairs, "bytes": 4.0 * elem + stat},
            "bwd": {"flops": 10.0 * d * pairs, "bytes": 8.0 * elem + stat}}


def bound_s(flops: float, nbytes: float, peak_flops: float,
            peak_bytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the peak bandwidth, in seconds."""
    return max(flops / peak_flops, nbytes / peak_bytes)
