"""Ulysses-style sequence parallelism: all_to_all head/sequence swap.
Counterpart of the JAX package's ``parallel/ulysses.py``.

Activations arrive sequence-sharded [B, H, S/n, D]; a differentiable
all_to_all over the ``sp`` axis re-shards them head-sharded [B, H/n, S, D],
so each rank runs full-sequence attention (the port's ``attention``: K1-K3
or K4-K6 on the card, by dtype and head dim) for a subset of heads; a
second all_to_all restores sequence sharding. Requires heads % sp == 0.
"""

from __future__ import annotations

from ..ops.attention import attention as _attention
from .collective import all_to_all
from .sharding import P, smap


def ulysses_attention_local(q, k, v, axis_name: str = "sp",
                            causal: bool = True, impl: str = "auto"):
    """Per-shard body (inside ``smap``). q/k/v: [B, H, S_local, D]."""

    def seq_to_heads(x):
        # [B, H, S/n, D] -> [B, H/n, S, D]: split heads, concat seq.
        return all_to_all(x, axis_name, split_axis=1, concat_axis=2,
                          tiled=True)

    def heads_to_seq(x):
        return all_to_all(x, axis_name, split_axis=2, concat_axis=1,
                          tiled=True)

    oh = _attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                    causal=causal, impl=impl)
    return heads_to_seq(oh)


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp",
                      causal: bool = True, impl: str = "auto",
                      batch_axes=("dp", "fsdp"), heads_axis="tp"):
    """Sharded entry point for [B, H, S, D] tensors (whole on every rank,
    or DTensors); returns a DTensor sharded as the input spec."""
    spec = P(batch_axes, heads_axis, axis_name, None)
    fn = smap(lambda q, k, v: ulysses_attention_local(
        q, k, v, axis_name=axis_name, causal=causal, impl=impl),
        mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v)
