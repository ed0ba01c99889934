"""The sampling tail's random draws, bit for bit as jax 0.9 makes them.

The JAX package samples a token with
``jax.random.categorical(fold_in(PRNGKey(seed), ctr), logits / temp)``,
under jax's default ``jax_threefry_partitionable=True``.  This module
repeats that sequence with torch integer ops on the logits' device,
vectorized over rows, so a request draws the same stream in the port as
in the JAX engine from the same seed:

1. ``PRNGKey(seed)``: the key (seed >> 32, seed & 0xffffffff);
2. ``fold_in(key, data)``: threefry-2x32 of the counter pair (0, data);
3. threefry-2x32: 20 rounds, rotations (13, 15, 26, 6) / (17, 29, 16, 24),
   a key injection after every 4 rounds;
4. partitionable ``random_bits``: the hash of the 64-bit iota split into
   (hi, lo) words, 32-bit bits = ``bits1 ^ bits2``;
5. ``uniform(minval=tiny, maxval=1)``: 23 mantissa bits under exponent 0,
   minus 1, scaled and shifted, floored at tiny;
6. ``gumbel`` ("low" mode): ``-log(-log(u))``;
7. ``categorical``: argmax(gumbel + logits).

Keys, random bits and uniforms equal jax's bit for bit.  The two logs of
the Gumbel transform are torch's, not XLA's, and may differ from them in
the last bits (at most a few 1e-7 absolute); a token flips only where two
candidates tie that closely.

torch has no full uint32 arithmetic, so a 32-bit word is held in int64
and every sum and shift is masked back to 32 bits.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the word pairs (x1, x2) under the key (k1, k2):
    int64 tensors holding uint32 values, broadcast together.  Returns the
    two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey`` of integer seeds (...,): (..., 2) int64 words."""
    seed = seed.to(torch.int64)
    return torch.stack([(seed >> 32) & _M32, seed & _M32], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` of keys (..., 2) with uint32 data (...,)."""
    data = data.to(torch.int64) & _M32
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([o1, o2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit ``random_bits`` of shape (..., n) per key (..., 2), as int64."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 ``jax.random.uniform`` of shape (..., n) per key."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # filled on the device, not copied from the host: a CUDA graph can
    # hold the draw
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """f32 ``jax.random.gumbel`` (mode "low") of shape (..., n) per key."""
    return -torch.log(-torch.log(uniform(key, n, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of f32 ``logits``
    (..., n), one key (..., 2) per row: int64 indices (...,)."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
