"""Kernel B's host layout and warp arithmetic (csrc/megakernel.cu leaf_mma,
tile_pairs; render/megakernel.py mxu_fragments): the plane tiles hold
every coefficient of mxu_plane_arrays exactly once, the reduction over a
ray's four lanes (and the 64-bit key reduction of the B2 copy in
tools/walk_variants) is the lexicographic (t, slot) minimum, and a ray
tile is skipped only when none of its rays hit the leaf. No JAX: numpy
copies of the kernel's warp steps against the plain rules."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scenes import get_scene

BIG = np.float32(1e30)      # the kernel's kBig
RAY_TILE = 8                # rays an m8n8k4 product takes (leaf_mma's tiles)


def _teapot(leaf):
    cfg = RenderConfig(width=16, height=12, samples=1, samples_per_pass=1)
    return get_scene("teapot", cfg).pack(device="cpu", leaf_size=leaf)


@pytest.mark.parametrize("leaf", [4, 8, 16, 32])
def test_fragment_layout_holds_each_coefficient_once(leaf):
    # the arrays' layout with each coefficient a group reads replaced by a
    # number of its own: every one lands in exactly one tile slot, every
    # other slot is 0, and mxu_groups reads the rows back
    arrays, meta = _teapot(leaf)
    a, _ = mk.mxu_plane_arrays(arrays, meta)
    nl, K = a.shape[0], meta.leaf_size
    assert K == leaf
    ids = np.zeros_like(a)
    n = 0
    for g, h in enumerate(mk._MXU_D_HALF):
        # a group reads one half of q: the other is zero in the arrays
        assert not a[:, g * K:(g + 1) * K, 4 * (1 - h):4 * (2 - h)].any()
        cols = slice(4 * h, 4 * h + 4)
        size = nl * K * 4
        ids[:, g * K:(g + 1) * K, cols] = (
            np.arange(n + 1, n + size + 1).reshape(nl, K, 4))
        n += size
    frag = mk.mxu_fragments(ids)
    assert frag.shape == (nl, mk.mxu_tiles(K), 32)
    assert frag.dtype == np.float32
    vals = frag[frag != 0]
    assert vals.size == n
    assert np.array_equal(np.sort(vals), np.arange(1, n + 1,
                                                   dtype=np.float32))
    # the real coefficients, decoded by the plain leaf's reader
    frag = mk.mxu_fragments(a)
    got = mk.mxu_groups(torch.from_numpy(frag), K).numpy()
    for g, h in enumerate(mk._MXU_D_HALF):
        assert np.array_equal(got[:, g],
                              a[:, g * K:(g + 1) * K, 4 * h:4 * h + 4])
    # the tiles a table built for MXU leaves carries, in that layout
    tris = torch.from_numpy(mk.build_mesh_tables(arrays, meta, "mxu")[1])
    assert np.array_equal(mk.mxu_view(tris, meta).numpy(), frag)


@pytest.mark.parametrize("leaf", [4, 8, 16, 32])
def test_fragment_lanes_match_the_products(leaf):
    # a tile is the B fragment of an m8n8k4 product whose A is 8 rays:
    # lane l holds coefficient l % 4 of column l // 4, so the product's
    # d_i (lane l) is column 2 (l % 4) + i; the columns are the kernel's
    # pairs (tile_pairs: triangle l % 4 at K <= 4, else 8 kt + 2 (l % 4)
    # + i of group g's tile)
    arrays, meta = _teapot(leaf)
    a, _ = mk.mxu_plane_arrays(arrays, meta)
    K = meta.leaf_size
    frag = mk.mxu_fragments(a)
    col = frag.reshape(frag.shape[0], frag.shape[1], 8, 4)  # [b, tile, n, c]
    rows = a.reshape(a.shape[0], 6, K, 8)
    half = [rows[:, g, :, 4 * h:4 * h + 4]
            for g, h in enumerate(mk._MXU_D_HALF)]
    if K <= 4:
        pairs = ((0, 3), (5, None), (1, 2), (4, None))
        for t, groups in enumerate(pairs):
            for n in range(8):
                c, j = divmod(n, 2)
                g = groups[j]
                want = (half[g][:, c] if g is not None and c < K
                        else np.zeros_like(col[:, t, n]))
                assert np.array_equal(col[:, t, n], want)
    else:
        nkt = -(-K // 8)
        for g in range(6):
            for kt in range(nkt):
                for n in range(8):
                    k = 8 * kt + n
                    want = (half[g][:, k] if k < K
                            else np.zeros_like(col[:, 0, n]))
                    assert np.array_equal(col[:, g * nkt + kt, n], want)


def _key(t, k):
    """B2's pair key: (float bits of t) << 32 | slot."""
    return (t.astype(np.float32).view(np.uint32).astype(np.uint64)
            << np.uint64(32)) | k.astype(np.uint64)


def _lex_min(t, k, u, v, K):
    """A numpy copy of leaf_mma's reduction for one 8-ray tile: lane l holds
    its best pair of ray l // 4 (t, k, u, v of [32]); two xor rounds over
    the ray's four lanes, each lane taking its partner's pair where that is
    (t, k)-lexicographically lower, then ray r's from lane 4 r. Returns
    (t, k, u, v) of the 8 rays."""
    t, k, u, v = t.copy(), k.copy(), u.copy(), v.copy()
    lanes = np.arange(32)
    for off in (1, 2):
        o = lanes ^ off
        take = (t[o] < t) | ((t[o] == t) & (k[o] < k))
        t, k, u, v = (np.where(take, x[o], x) for x in (t, k, u, v))
    src = 4 * np.arange(8)
    return t[src], k[src], u[src], v[src]


def _key_min(t, k, u, v, K):
    """The same by one 64-bit key (tools/walk_variants b2, b3a-key: not
    shipped): the keys' minimum over the ray's four lanes by two xor
    rounds, then the winner's u and v from the lane that holds its
    triangle, 4 r + (k % 4 for K <= 4, else (k % 8) // 2)."""
    key = _key(t, k)
    lanes = np.arange(32)
    for off in (1, 2):
        key = np.minimum(key, key[lanes ^ off])
    won = key[4 * np.arange(8)]
    kk = (won & np.uint64(0xFFFFFFFF)).astype(np.int64)
    src = 4 * np.arange(8) + (kk & 3 if K <= 4 else (kk & 7) >> 1)
    tt = (won >> np.uint64(32)).astype(np.uint32).view(np.float32)
    return tt, kk, u[src], v[src]


def _lexmin(t, k):
    """The plain rule: each ray's lowest t, the lowest slot on ties."""
    out_t, out_k = [], []
    for r in range(8):
        cand = sorted(zip(t[4 * r:4 * r + 4].tolist(),
                          k[4 * r:4 * r + 4].tolist()))
        out_t.append(cand[0][0])
        out_k.append(cand[0][1])
    return np.asarray(out_t, np.float32), np.asarray(out_k)


@pytest.mark.parametrize("reduce", [_lex_min, _key_min],
                         ids=["lexicographic", "key"])
@pytest.mark.parametrize("K", [4, 8, 32])
@pytest.mark.parametrize("case", ["random", "ties", "big"])
def test_key_reduction_is_the_lexicographic_minimum(K, case, reduce):
    rng = np.random.default_rng(10 * K + ("random", "ties", "big").index(case))
    for _ in range(200):
        lane = np.arange(32)
        # this lane's pair: triangle l % 4 (K <= 4), or one of its two
        # columns 8 kt + 2 (l % 4) + i (K > 4)
        if K <= 4:
            k = lane & 3
        else:
            k = 8 * rng.integers(0, K // 8, 32) + 2 * (lane & 3) + \
                rng.integers(0, 2, 32)
        t = rng.uniform(1e-3, 50.0, 32).astype(np.float32)
        if case == "ties":
            t = rng.choice(np.float32([0.5, 2.0, 3.25]), 32)
        elif case == "big":
            t = np.where(rng.random(32) < 0.7, BIG, t).astype(np.float32)
            t[rng.integers(0, 32, 4)] = BIG
        u = rng.random(32).astype(np.float32)
        v = rng.random(32).astype(np.float32)
        tt, kk, uu, vv = reduce(t, k, u, v, K)
        want_t, want_k = _lexmin(t, k)
        assert np.array_equal(tt, want_t)
        assert np.array_equal(kk, want_k)
        # u and v come from the lane that holds the winning pair
        for r in range(8):
            src = 4 * r + np.flatnonzero(
                (t[4 * r:4 * r + 4] == want_t[r])
                & (k[4 * r:4 * r + 4] == want_k[r]))[0]
            assert uu[r] == u[src] and vv[r] == v[src]


def test_key_orders_as_t_then_slot():
    # every t the leaf yields is positive (t > eps, or kBig): there the
    # key's order (tools/walk_variants b2) is (t, slot)'s, across the
    # whole f32 range
    rng = np.random.default_rng(7)
    bits = rng.integers(1, 0x7F800000, 100000, dtype=np.int64)
    t = bits.astype(np.uint32).view(np.float32)
    t = np.concatenate([t, [BIG, np.float32(1e-4), np.float32(1e-4)]])
    k = rng.integers(0, 32, t.size)
    key = _key(t, k)
    i, j = rng.integers(0, t.size, (2, 200000))
    lex = (t[i] < t[j]) | ((t[i] == t[j]) & (k[i] < k[j]))
    assert np.array_equal(key[i] < key[j], lex)


@pytest.mark.parametrize("seed", range(4))
def test_ray_tile_skip_only_without_a_hit(seed):
    # leaf_mma: hits = ballot(hit); the 8-ray tile ct runs only if its bits
    # of `hits` (ct * 8 .. ct * 8 + 7) are not all 0, i.e. some ray's slab
    # hit the leaf
    rng = np.random.default_rng(seed)
    for _ in range(500):
        hit = rng.random(32) < rng.choice([0.0, 0.02, 0.2, 0.9])
        hits = int(sum(1 << i for i in np.flatnonzero(hit)))
        for s in range(32 // RAY_TILE):
            run = (hits >> (RAY_TILE * s)) & ((1 << RAY_TILE) - 1) != 0
            assert run == bool(hit[RAY_TILE * s:RAY_TILE * (s + 1)].any())
