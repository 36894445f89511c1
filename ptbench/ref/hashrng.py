"""The counter-hash random stream of the forward megakernel.

Frozen copy of `_prng_key` and `_hash_uniform` of
pathtracer_tpu_torch/render/megakernel.py at commit 7dc6265 (the murmur3
finalizer over (seed, tile, draw id, sample, bounce, slot)), with the
sample index `n` allowed to be a tensor, so that many samples of a slot
run in one batch. int64 tensors, masked back to 32 bits after every
multiply and add (the CPU has no >> for uint32).
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
INV24 = float(2.0 ** -24)


def tile_key(seed, tile):
    """Per-tile key: seed*0x9E3779B1 ^ tile*0x85EBCA77 (mod 2^32); `seed`
    an int or an int64 tensor of values below 2^32."""
    tile = torch.as_tensor(tile, dtype=torch.int64)
    if not isinstance(seed, torch.Tensor):
        seed = int(seed) & M32
    return ((seed * 0x9E3779B1) & M32) ^ ((tile * 0x85EBCA77) & M32)


def uniform(key, elem, did: int, n=None, b: int = None):
    """f32 uniforms in [0, 1): the top 24 bits of the murmur3 finalizer
    over key ^ did*C1 + n*C2 + b*C3 + elem; `n` an int or an int64
    tensor."""
    h = key ^ ((did * 0xC2B2AE3D) & M32)
    if n is not None:
        if isinstance(n, torch.Tensor):
            h = (h + ((n * 0x27D4EB2F) & M32)) & M32
        else:
            h = (h + ((int(n) * 0x27D4EB2F) & M32)) & M32
    if b is not None:
        h = (h + ((int(b) * 0x165667B1) & M32)) & M32
    x = (h + elem) & M32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & M32
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * INV24
