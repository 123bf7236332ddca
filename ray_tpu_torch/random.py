"""``jax.random``'s default PRNG, drawing the same bits as JAX 0.9.

The pieces are threefry2x32 (20 rounds), ``PRNGKey`` of an int32 seed
(negative ones too: the key is ``[0, seed mod 2**32]``), ``fold_in``,
``split`` and ``random_bits``, and the draws built on them: ``uniform``,
``randint``, ``choice`` (with replacement), ``permutation``, ``gumbel``
and ``categorical``. The counter layout is the one of
``jax_threefry_partitionable=True`` (the default since JAX 0.5, and what
JAX 0.9 uses): element ``i`` of a draw takes ``y0 ^ y1`` of
``threefry(key, (0, i))``. With the flag off JAX lays the counters out
differently and the draws differ.

A key is a pair of uint32 words. The words live in int64 tensors masked
to 32 bits after every add and shift, since not every CUDA path has
uint32. A key's words may carry leading dimensions: a batch of keys, as
under ``jax.vmap``, each drawing its own block. Every function here is
integer arithmetic plus a few fp32 operations, with no host sync, so it
runs inside a CUDA graph.

``uniform`` and ``randint`` follow ``jax/_src/random.py`` ``_uniform``
and ``_randint`` operation for operation, so their draws are bit-equal.
The Gumbel noise is ``-log(-log(u))`` with XLA's own fp32 ``log``
(``xla_log``), so it is bit-equal too, and so is ``categorical``.
``normal`` draws JAX's uniforms but takes ``torch.erfinv`` of them, so it
is equal to JAX's within a stated tolerance, not bit for bit.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
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
    ``threefry(key, (0, i))``. Returns words of shape ``key + (num,)``;
    ``take(keys, i)`` picks key ``i``."""
    i = torch.arange(num, dtype=torch.int64, device=key[0].device)
    return threefry2x32(key[0][..., None], key[1][..., None],
                        torch.zeros_like(i), i)


def take(keys: Key, i) -> Key:
    """Key ``i`` along the last dimension of ``keys`` (as ``split`` made
    them): ``jax.random.split(key)[i]``."""
    return keys[0][..., i], keys[1][..., i]


def random_bits(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits for each position of ``shape``, for each key: int64
    words of shape ``key + shape``. The counter of a position is its index
    in the flattened ``shape`` (the partitionable layout)."""
    shape = tuple(shape)
    i = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=key[0].device).reshape(shape)
    lift = (...,) + (None,) * len(shape)
    y0, y1 = threefry2x32(key[0][lift], key[1][lift], torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """fp32 ``jax.random.uniform(key, shape, minval=, maxval=)``: the top
    23 bits as a float in [1, 2), minus 1, times the fp32 span plus
    ``minval``, floored at ``minval``.

    XLA's CPU code fuses that product and sum into one fused multiply-add,
    rounded once. So does this: the product of two fp32 values is exact
    in float64, and so is its sum with ``minval`` while the result needs
    at most 53 bits (ranges of moderate magnitude, such as every one the
    port draws from; a ``minval`` of fp32 ``tiny`` only floors zero).
    One rounding to fp32 then gives the fused result on any device."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # The fp32 bounds and span, as host floats: no host-to-device copy,
    # which a CUDA graph could not hold.
    lo = np.float32(minval)
    span, lo = float(np.float32(maxval) - lo), float(lo)
    return torch.clamp_min((floats.double() * span + lo).float(), lo)


def randint(key: Key, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """int32 ``jax.random.randint``, as int64: two 32-bit draws (keys
    ``split(key)``) combined modulo the span, in uint32 arithmetic."""
    span = maxval - minval if maxval > minval else 1
    if not 0 < span <= _MASK:
        raise ValueError(f"randint span {span} does not fit 32 bits")
    keys = split(key)
    higher = random_bits(take(keys, 0), shape)
    lower = random_bits(take(keys, 1), shape)
    multiplier = ((2 ** 16 % span) ** 2 & _MASK) % span  # uint32 wraps
    offset = ((higher % span) * multiplier) & _MASK
    offset = ((offset + lower % span) & _MASK) % span
    return minval + offset


def choice(key: Key, values: torch.Tensor,
           shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.choice(key, values, shape)`` with replacement and no
    weights: ``values[randint(key, shape, 0, len(values))]``."""
    return values[randint(key, shape, 0, values.shape[0])]


def permutation(key: Key, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (``_shuffle``): rounds of a
    stable sort of ``arange(n)`` on fresh 32-bit keys, ``ceil(3 ln n /
    ln(2**32 - 1))`` of them (two at n = 32768, one up to 1625). A batch
    of keys gives a batch of permutations, int64 of shape ``key +
    (n,)``."""
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_MASK))
    x = torch.arange(n, device=key[0].device).expand(key[0].shape + (n,))
    for _ in range(rounds):
        keys = split(key)
        key = take(keys, 0)
        order = torch.argsort(random_bits(take(keys, 1), (n,)), dim=-1,
                              stable=True)
        x = torch.gather(x, -1, order)
    return x


# XLA's CPU fp32 ``log`` (Cephes' polynomial, as in Eigen's ``plog``): the
# mantissa's log1p by a degree-9 polynomial, plus the exponent times ln 2
# split in two parts. The constants are fp32, held as Python floats.
_LOG_P = tuple(float(np.float32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = 0.693359375
_SQRT_HALF = float(np.float32(0.707106781186547524))


def _fma_to_odd(a, b, c) -> torch.Tensor:
    """fp32 ``fma(a, b, c)``, rounded once, for fp32 ``a`` and ``c`` and a
    float64 ``b`` that holds fp32 values: the float64 product is exact,
    the float64 sum is rounded to odd (an inexact sum goes to the odd of
    its two neighbours, by the sign of its exact remainder), and rounding
    that to fp32 gives the correctly rounded result."""
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # two-sum: exactly p + c - s
    bits = s.view(torch.int64)
    bits = torch.where(err * s < 0, bits - 1, bits) | (err != 0)
    return bits.view(torch.float64).float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """fp32 natural log of positive normal ``x``, bit for bit as XLA's CPU
    backend computes it: ``frexp`` to m in [0.5, 1), folded to
    [sqrt(1/2), sqrt(2)) and shifted by 1; the polynomial by Horner in
    three interleaved parts; then ``e * q1``, ``-x**2 / 2`` and
    ``e * q2`` added in XLA's order, its multiply-adds fused.

    Each fused step is one rounding of the exact result. The products of
    ``x`` with a coefficient sum values on grids of 2**-51 or coarser
    below 0.5: exact in float64, rounded once to fp32. ``x**2 / 2`` and
    ``e * q2`` are exact in fp32, so those steps are fp32 additions. The
    products with ``x**3`` go through ``_fma_to_odd``. Zero, subnormals,
    infinities and negative inputs are not handled: the callers floor at
    fp32 ``tiny``."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 126).float()
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)
    fold = m < _SQRT_HALF
    x = torch.where(fold, m + m, m) - 1.0  # exact
    e = torch.where(fold, e - 1.0, e)
    x2 = x * x
    x3 = (x2 * x).double()
    xd = x.double()
    p = _LOG_P
    y = (xd * p[0] + p[1]).float()
    y1 = (xd * p[3] + p[4]).float()
    y2 = (xd * p[6] + p[7]).float()
    y = (y * xd + p[2]).float()
    y1 = (y1 * xd + p[5]).float()
    y2 = (y2 * xd + p[8]).float()
    y = _fma_to_odd(y, x3, y1)
    y = _fma_to_odd(y, x3, y2)
    y = _fma_to_odd(y, x3, e * _LOG_Q1)
    return (x - x2 * 0.5) + y + e * _LOG_Q2


def gumbel(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel``: ``-log(-log(u))`` of ``uniform`` floored at
    fp32 ``tiny``, with XLA's ``log``."""
    tiny = torch.finfo(torch.float32).tiny
    return -xla_log(-xla_log(uniform(key, shape, minval=tiny)))


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """fp32 ``jax.random.normal``: ``sqrt(2) * erfinv(u)`` of ``uniform``
    over [nextafter(-1, 0), 1), as ``jax._src.random._normal_real``.

    The uniform draws are bit-equal to JAX's. ``torch.erfinv`` is not
    XLA's fp32 ``erf_inv`` polynomial, so the normals are not: on 10**6
    draws 59% of them differ from JAX 0.9's on the CPU, by at most 2.2e-5
    absolute (in the tails) and 6e-6 of the draw's size
    (``tests/test_torch_rllib_offpolicy.py`` holds them to that)."""
    u = uniform(key, shape, minval=_NORMAL_LO, maxval=1.0)
    return torch.erfinv(u) * _SQRT2


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (Gumbel-max; ties go
    to the first index). The key's dimensions are leading dimensions of
    ``logits`` (one key per row, as under ``jax.vmap``); one key draws
    the noise of all the rest of ``logits`` at once."""
    shape = tuple(logits.shape[key[0].ndim:])
    return torch.argmax(gumbel(key, shape) + logits, dim=-1)
