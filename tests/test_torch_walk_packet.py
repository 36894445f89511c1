"""pathtracer_tpu_torch's plain packet walks against the JAX package's, in
interpret mode on the CPU (the harness of tests/test_packet_traverse.py):
`_packet_traverse` under PT_SUBPACKET=2 (the scratch-gated walk of one
(8, 512) tile on the tile's majority octant copy), the per-chunk walks of
PT_SUBPACKET=3 (each 128-lane chunk on its own majority copy, as
_make_kernel :1992-2008 runs them) and `_packet_traverse_mxu`
(PT_TRAVERSAL=mxu). The port's traverse_reference walks the same rays with
the JAX package's octant groups (the tile, or the chunk) and the kernel's
packets (a warp's 32 slots share a node pointer), with the dual-basis or
the tensor-core leaf tests. Rules: the same hit or miss on >= 99.9% of
rays, t within 1e-5 relative and smooth normals within 1e-4 where both
hit; colors equal except at exact-t ties (the MXU machine averages a tie's
payload). The tensor-core t may also be 1e-7 off near t = 0: its num_t
is -Ng.o + P1.Ng, whose f32 rounding of P1.Ng is that much on the teapot
(the JAX package's MXU dots round in f32, the port's once from exact f64
products)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.probes.leaf_bench import mesh_rays
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scenes import get_scene

torch.set_num_threads(2)

S, L = 8, 512
BIG = mk._BIG


@functools.lru_cache(maxsize=None)
def _mesh():
    cfg = RenderConfig(width=16, height=12, samples=1, samples_per_pass=1)
    arrays, meta = get_scene("teapot", cfg).pack(device=torch.device("cpu"))
    nodes, tris = mk.build_mesh_tables(arrays, meta, traversal="classic")
    mxu = pk._mxu_pack(np, *mk.mxu_plane_arrays(arrays, meta),
                       meta.leaf_size)
    return cfg, arrays, meta, nodes, tris, mxu


def _rays(arrays, seed):
    # rays aimed into the mesh from all sides: every octant in the tile
    return [r.numpy() for r in mesh_rays(arrays, S * L, "cpu", seed=seed)]


def _jax_walk(meta, cfg, nodes, tris, rays, mode):
    """The JAX walk of `mode` (2, 3 or "mxu") in an interpret-mode
    pallas_call on one (8, 512) tile of rays, all active: (t, nx, ny, nz,
    cr, cg, cb) flat."""
    K = meta.leaf_size
    (_, root, end), = meta.group_bvh

    def walk(node_ref, tri_ref, ox, oy, oz, dx, dy, dz, act, bt0):
        ob = pk._group_octant_base(meta, act, dx, dy, dz)
        if mode == "mxu":
            return pk._packet_traverse_mxu(
                node_ref, tri_ref, K, meta.n_tri_slots, cfg.epsilon,
                cfg.t_max, root, end, ox, oy, oz, dx, dy, dz, act, bt0,
                oct_base=ob)
        return pk._packet_traverse(
            node_ref, tri_ref, K // pk._TRI_SLOTS_PER_ROW, cfg.epsilon,
            cfg.t_max, root, end, ox, oy, oz, dx, dy, dz, act, bt0,
            oct_base=ob)

    def kernel(node_ref, tri_ref, *refs):
        ins, outs = refs[:6], refs[6:]
        r = [x[...] for x in ins]
        bt0 = jnp.full((S, L), pk._BIG, jnp.float32)
        act = jnp.ones((S, L), jnp.bool_)
        if mode == 3:
            parts = [walk(node_ref, tri_ref,
                          *[x[:, j * 128:(j + 1) * 128] for x in r],
                          act[:, j * 128:(j + 1) * 128],
                          bt0[:, j * 128:(j + 1) * 128])
                     for j in range(L // 128)]
            res = [jnp.concatenate([p[k] for p in parts], axis=1)
                   for k in range(7)]
        else:
            res = walk(node_ref, tri_ref, *r, act, bt0)
        for ref, val in zip(outs, res):
            ref[...] = val

    f32 = jax.ShapeDtypeStruct((S, L), jnp.float32)
    outs = pl.pallas_call(
        kernel, in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 8,
        out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 7,
        out_shape=[f32] * 7, interpret=True,
    )(jnp.asarray(nodes), jnp.asarray(tris),
      *[jnp.asarray(x.reshape(S, L)) for x in rays])
    return [np.asarray(o).reshape(-1) for o in outs]


def _port_walk(meta, cfg, nodes, tris, rays, mode):
    """traverse_reference on the same rays, grouped as the JAX walk of
    `mode` groups them, a warp's 32 slots a packet."""
    (_, root, end), = meta.group_bvh
    n = S * L
    i = torch.arange(n)
    octant_group = (i % L) // 128 if mode == 3 else torch.zeros_like(i)
    walk = mk.Walk("warp" if mode == 3 else "block",
                   "mma" if mode == "mxu" else "simt")
    tri_t = torch.from_numpy(tris)
    out = mk.traverse_reference(
        torch.from_numpy(nodes), tri_t, meta.leaf_size, cfg.epsilon,
        cfg.t_max, root, end, *(torch.from_numpy(r) for r in rays),
        torch.ones(n, dtype=torch.bool), torch.full((n,), BIG),
        n_nodes=meta.n_nodes, walk=walk, groups=(octant_group, i // 32),
        mxu=mk.mxu_view(tri_t, meta) if mode == "mxu" else None)
    return [x.numpy() for x in out]


def _rule(got, want, colors_exact=True):
    whit, ghit = want[0] < BIG, got[0] < BIG
    assert (whit == ghit).mean() >= 0.999
    assert whit.sum() > got[0].size // 4
    both = whit & ghit
    np.testing.assert_allclose(got[0][both], want[0][both], rtol=1e-5,
                               atol=0.0 if colors_exact else 1e-7)
    for k in range(1, 4):
        close = np.abs(got[k][both] - want[k][both]) <= 1e-4
        assert close.mean() >= (1.0 if colors_exact else 0.999)
    for k in range(4, 7):
        same = got[k][both] == want[k][both]
        assert same.mean() >= (1.0 if colors_exact else 0.999)


@pytest.mark.parametrize("mode,seed", [(2, 11), (3, 12)])
def test_packet_walk_matches_jax(monkeypatch, mode, seed):
    # PT_SUBPACKET=2 sends _packet_traverse to the scratch-gated walk
    monkeypatch.setenv("PT_SUBPACKET", str(mode))
    cfg, arrays, meta, nodes, tris, _ = _mesh()
    rays = _rays(arrays, seed)
    want = _jax_walk(meta, cfg, nodes, tris, rays, mode)
    got = _port_walk(meta, cfg, nodes, tris, rays, mode)
    _rule(got, want)
    # the same hits as the per-thread walk (its own octant copy each)
    free = mk.traverse_reference(
        torch.from_numpy(nodes), torch.from_numpy(tris), meta.leaf_size,
        cfg.epsilon, cfg.t_max, *meta.group_bvh[0][1:],
        *(torch.from_numpy(r) for r in rays),
        torch.ones(S * L, dtype=torch.bool), torch.full((S * L,), BIG),
        n_nodes=meta.n_nodes)
    assert np.array_equal(free[0].numpy() < BIG, got[0] < BIG)


def test_mxu_walk_matches_jax(monkeypatch):
    monkeypatch.setenv("PT_TRAVERSAL", "mxu")
    cfg, arrays, meta, nodes, tris, mxu = _mesh()
    rays = _rays(arrays, 13)
    want = _jax_walk(meta, cfg, nodes, mxu, rays, "mxu")
    tris_m = mk.build_mesh_tables(arrays, meta, traversal="mxu")[1]
    got = _port_walk(meta, cfg, nodes, tris_m, rays, "mxu")
    _rule(got, want, colors_exact=False)


def test_mxu_leaf_matches_the_dual_basis_leaf():
    # every ray against every leaf: the tensor-core test's t within 1e-5
    # (1e-7 near 0) of the dual-basis test's, the winner equal except at
    # exact-t ties
    cfg, arrays, meta, nodes, tris, _ = _mesh()
    K = meta.leaf_size
    tris_m = torch.from_numpy(
        mk.build_mesh_tables(arrays, meta, traversal="mxu")[1])
    frag = mk.mxu_view(tris_m, meta)
    rays = [torch.from_numpy(r) for r in _rays(arrays, 14)[:6]]
    ties = hits = 0
    for leaf in range(meta.n_tri_slots // K):
        start = torch.full((S * L,), leaf * K)
        tw, slot, u, v = mk.leaf_tests(tris_m.reshape(-1, 24), start, K,
                                        cfg.epsilon, *rays)
        mt, ms, mu, mv = mk.leaf_tests_mma(frag, start, K, cfg.epsilon,
                                            *rays)
        hit = tw < BIG
        hits += int(hit.sum())
        assert (hit == (mt < BIG)).float().mean() >= 0.999
        both = hit & (mt < BIG)
        assert torch.allclose(mt[both], tw[both], rtol=1e-5, atol=1e-7)
        pairs = mk.leaf_tests_mma(frag, start, K, cfg.epsilon, *rays,
                                   pairs=True)
        differ = both & (ms != slot)
        # a differing winner is a tie: the classic winner's MXU t equals
        # the MXU winner's
        alt = pairs[differ, (slot[differ] - leaf * K)]
        assert torch.equal(alt, mt[differ])
        ties += int(differ.sum())
    assert hits > 1000 and ties <= hits // 100
