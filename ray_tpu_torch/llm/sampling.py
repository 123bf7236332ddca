"""Seeded token sampling that draws the same tokens as ``jax.random``.

Token ``q`` of a request with seed ``s`` is drawn as
``jax.random.categorical(fold_in(PRNGKey(s), q), logits / max(t, 1e-6))``
(the JAX engine's ``_sample``), greedy where ``t == 0``. Drawing the same
tokens as the JAX package, given the same fp32 logits, keeps a seeded
request portable across engines: a session migrated between engines, or a
client-seeded retry replayed on another replica, continues with the same
tokens.

The draws are ``ray_tpu_torch.random``'s, the same bits as JAX's
default PRNG, and the Gumbel noise is XLA's bit for bit (``xla_log``), so
given the same logits the tokens are the same.
"""

from __future__ import annotations

import torch

from ..random import categorical, fold_in, prng_key


def sample(logits, temps, seeds, qpos) -> torch.Tensor:
    """The JAX engine's ``_sample``: greedy where ``temps == 0``, else
    token ``qpos`` of seed ``seeds`` at temperature ``temps``. logits
    ``[B, V]`` fp32; temps fp32, seeds int32, qpos int ``[B]``. Returns
    ``[B]`` int32."""
    greedy = torch.argmax(logits, dim=-1)
    key = fold_in(prng_key(seeds), qpos)
    sampled = categorical(
        key, logits / torch.clamp_min(temps, 1e-6)[:, None])
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)
