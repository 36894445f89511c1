"""The wavefront path's random stream: jax.random's threefry2x32, as
torch int64 ops.

The JAX package's wavefront integrator draws only through
`jax.random.PRNGKey`, `jax.random.fold_in` and `jax.random.uniform(key,
shape, float32)`, with `jax_threefry_partitionable` on (its default in
jax 0.9). This module copies those three, bit for bit, so the port traces
the same paths as the JAX package pixel by pixel:

- a key is an int64 tensor [2] on the CPU holding the two uint32 words of
  JAX's raw key (the host derives keys; no global generator is used);
- `fold_in(key, data)` hashes the counter pair (0, data) under the key
  (JAX's threefry_seed(data) followed by threefry_2x32);
- `uniform(key, shape)` hashes element i's 64-bit flat index, split into
  its high and low words, takes the xor of the two output words, and
  turns its top 23 bits into a float in [0, 1).

uint32 arithmetic is int64 arithmetic masked to 32 bits: torch has no
right shift for uint32 on the CPU. Each fold_in and uniform runs in the
span "pt.rng" (spans.py).
"""
from __future__ import annotations

import math

import torch

from ..spans import span

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 block function (20 rounds) of key (k1, k2) on
    counter words x0, x1 (int64 tensors holding uint32 values); returns
    the two output words, as jax's _threefry2x32_lowering computes them."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """jax.random.PRNGKey(seed): the words (seed >> 32, seed & 0xFFFFFFFF)
    of a 64-bit seed (for seeds in [0, 2^31) the same under jax's 32-bit
    default)."""
    return torch.tensor([(seed >> 32) & _M32, seed & _M32],
                        dtype=torch.int64)


def _words(key: torch.Tensor):
    return int(key[0]), int(key[1])


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in(key, data) for a data word in [0, 2^32)."""
    with span("pt.rng"):
        x0 = torch.zeros(1, dtype=torch.int64)
        x1 = torch.tensor([int(data) & _M32], dtype=torch.int64)
        y0, y1 = threefry2x32(*_words(key), x0, x1)
        return torch.cat([y0, y1])


def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """jax.random.bits(key, shape) for 32-bit words (partitionable
    threefry), as an int64 tensor of uint32 values on `device`."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(*_words(key), idx >> 32, idx & _M32)
    return (b0 ^ b1).reshape(shape)


def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32): floats in [0, 1) on
    `device`, bit for bit."""
    with span("pt.rng"):
        bits = random_bits(key, shape, device)
        one = 0x3F800000  # the bits of 1.0f
        f = ((bits >> 9) | one).to(torch.int32).view(torch.float32)
        return f - 1.0
