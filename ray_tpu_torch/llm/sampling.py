"""Seeded token sampling that draws the same tokens as ``jax.random``.

Token ``q`` of a request with seed ``s`` is drawn as
``jax.random.categorical(fold_in(PRNGKey(s), q), logits / max(t, 1e-6))``
(the JAX engine's ``_sample``), greedy where ``t == 0``. Drawing the same
tokens as the JAX package, given the same fp32 logits, keeps a seeded
request portable across engines: a session migrated between engines, or a
client-seeded retry replayed on another replica, continues with the same
tokens.

The pieces are JAX's default PRNG: threefry2x32 (20 rounds), ``PRNGKey``
of an int32 seed (negative ones too: the key is ``[0, seed mod 2**32]``),
``fold_in``/``split`` and ``random_bits``. The counter layout over a
``(V,)`` draw is the one of ``jax_threefry_partitionable=True`` (the
default since JAX 0.5, and what JAX 0.9 uses): element ``i`` takes
``y0 ^ y1`` of ``threefry(key, (0, i))``. With the flag off JAX lays the
counters out differently and the draws differ.

The words are uint32, which not every CUDA path has: they live in int64
tensors masked to 32 bits after every add and shift.

Uniforms are ``bits >> 9 | 1.0f`` minus 1, floored at the fp32 ``tiny``,
and the Gumbel noise is ``-log(-log(u))``. PyTorch's ``log`` and XLA's
round differently in the last bit of some floats, so the noise agrees to
about 1e-6 absolute; a token differs only where two candidates tie
within that.
"""

from __future__ import annotations

from typing import Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[torch.Tensor, torch.Tensor]


def threefry2x32(k0, k1, x0, x1) -> Key:
    """Threefry-2x32, 20 rounds, on uint32 words held in int64 tensors
    (broadcast together). The rounds work in place on the two fresh
    state tensors: a draw of a [rows, vocab] block is tens of MB a word."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK)
            high = x1 << r  # rotate left by r within 32 bits
            x1.bitwise_right_shift_(32 - r).bitwise_or_(high)
            x1.bitwise_and_(_MASK).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_MASK)
    return x0, x1


def prng_key(seed, device=None) -> Key:
    """``jax.random.PRNGKey`` of int32 seed(s): the words ``(0, seed mod
    2**32)``, one key per element of ``seed``."""
    s = torch.as_tensor(seed, device=device).to(torch.int64)
    return torch.zeros_like(s), s & _MASK


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in``: ``threefry(key, (0, data mod 2**32))``."""
    d = torch.as_tensor(data, device=key[0].device).to(torch.int64) & _MASK
    return threefry2x32(key[0], key[1], torch.zeros_like(d), d)


def split(key: Key, num: int = 2) -> Key:
    """``jax.random.split`` (partitionable layout): key ``i`` is
    ``threefry(key, (0, i))``. Returns words of shape ``key + (num,)``."""
    i = torch.arange(num, dtype=torch.int64, device=key[0].device)
    return threefry2x32(key[0][..., None], key[1][..., None],
                        torch.zeros_like(i), i)


def random_bits(key: Key, shape: Tuple[int, ...]) -> torch.Tensor:
    """32 random bits for each position of ``shape``, for each key: int64
    words of shape ``key + shape``. The counter of a position is its index
    in the flattened ``shape`` (the partitionable layout)."""
    n = 1
    for d in shape:
        n *= d
    i = torch.arange(n, dtype=torch.int64, device=key[0].device).reshape(
        shape)
    lift = (...,) + (None,) * len(shape)
    y0, y1 = threefry2x32(key[0][lift], key[1][lift], torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(key: Key, shape: Tuple[int, ...]) -> torch.Tensor:
    """fp32 uniforms in [tiny, 1) as ``jax.random.uniform(key, shape,
    minval=tiny)`` draws them."""
    tiny = torch.finfo(torch.float32).tiny
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # floats * (maxval - minval) + minval with maxval - minval == 1.0f.
    return torch.clamp_min(floats + tiny, tiny)


def gumbel(key: Key, shape: Tuple[int, ...]) -> torch.Tensor:
    return -torch.log(-torch.log(uniform(key, shape)))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (Gumbel-max; ties go
    to the first index). The key's dimensions are leading dimensions of
    ``logits`` (one key per row, as under ``jax.vmap``); one key draws
    the noise of all the rest of ``logits`` at once."""
    shape = tuple(logits.shape[key[0].ndim:])
    return torch.argmax(gumbel(key, shape) + logits, dim=-1)


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
