"""The parts of ``jax.random`` the sampler draws from, on torch integer ops:
the threefry2x32 hash, ``key(seed)``, ``fold_in(key, data)``, 32-bit random
bits, ``uniform`` and ``gumbel`` (the "low" mode), bitwise equal to
``jax.random`` under ``jax_threefry_partitionable=True`` (the default since
jax 0.5) for the integer bits and the uniforms.

A key is a pair of uint32 words ``(k1, k2)``. torch has no complete uint32
arithmetic on the card, so every word is held in an int64 tensor with its
value in [0, 2^32): each add and rotate is masked back to 32 bits, and a
right shift of a non-negative int64 is a logical one. Keys are batched: a
``[B]`` pair of words is B keys, and :func:`random_bits` draws a ``[B, n]``
block, one row per key, in one pass over the whole block.

The recipe (jax ``_src/prng.py`` and ``_src/random.py``):

* ``key(seed)`` of an int32 seed is ``(0, seed mod 2^32)``;
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, uint32(d)))``;
* the bits of a flat index i are ``x0 ^ x1`` of ``threefry2x32(key, (hi,
  lo))``, (hi, lo) the index's 64 bits (hi is 0 below 2^32 draws);
* ``uniform(key, n, tiny, 1)``: the top 23 bits ORed into 1.0's pattern,
  minus 1, scaled to [tiny, 1) and clamped below at tiny;
* ``gumbel``: ``-log(-log(u))`` of that uniform.

``log`` is the one float function: torch's and XLA's may round it apart, so
gumbel values agree to a few float32 steps (``tests/test_torch_prng.py``
states the bound); the bits and uniforms are bitwise.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds) of the counter words ``(x0, x1)``
    under the key ``(k1, k2)``; int64 tensors holding uint32 values, which
    broadcast against each other. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.key`` of int32 seeds ``[B]``: the keys ``(0, seed mod
    2^32)`` as int64 words."""
    s = seed.to(torch.int64) & _M32
    return torch.zeros_like(s), s


def fold_in(k: tuple[torch.Tensor, torch.Tensor],
            data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in`` of each key with its int32 ``data`` (the
    value taken mod 2^32, as jax's uint32 conversion does)."""
    d = data.to(torch.int64) & _M32
    return threefry2x32(k[0], k[1], torch.zeros_like(d), d)


def random_bits(k: tuple[torch.Tensor, torch.Tensor], n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each of the B keys:
    ``[B, n]`` int64 holding uint32 values."""
    k1, k2 = k[0][:, None], k[1][:, None]
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)[None, :]
    b0, b1 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b0 ^ b1


def uniform(k: tuple[torch.Tensor, torch.Tensor], n: int,
            minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, 1)`` for each key:
    ``[B, n]`` float32."""
    bits = (random_bits(k, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    span = float(torch.tensor(1.0, dtype=torch.float32) - lo)
    return torch.clamp_min(floats * span + float(lo), float(lo))


def gumbel(k: tuple[torch.Tensor, torch.Tensor], n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low") for each key:
    ``[B, n]`` float32."""
    return -torch.log(-torch.log(uniform(k, n, _TINY)))
