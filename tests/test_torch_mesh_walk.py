"""pathtracer_tpu_torch's plain BVH walk (`traverse_reference`) against the
JAX package's packet walk and a brute-force closest hit.

`_packet_traverse` is driven in an interpret-mode pallas_call harness (the
pattern of tests/test_packet_traverse.py, copied here) on the `teapot`
tables; the rays are those of that file: aimed into the mesh's box, the
last quarter aimed away. The packet walk follows one node pointer for all
rays and the port's walk one per ray; they find the same closest hits
except on exact-t ties. Rules: the same hit or miss on >= 99.9% of rays,
t within 1e-5 relative and smooth normals within 1e-4 where both hit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from _torch_scenes import size_check_scene
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scenes import get_scene

torch.set_num_threads(2)

TILE = (8, 512)
BIG = mk._BIG


@functools.lru_cache(maxsize=None)
def _mesh(name):
    cfg = RenderConfig(width=16, height=12, samples=1, samples_per_pass=1)
    sc = (size_check_scene(cfg, get_scene) if name == "size-check"
          else get_scene(name, cfg))
    arrays, meta = sc.pack(device=torch.device("cpu"))
    return cfg, arrays, meta, mk.build_mesh_tables(arrays, meta)


def _packet_interpret(meta, cfg, arrays, rays):
    """One interpret-mode pallas_call around pk._packet_traverse, walking
    node copy 0 of the single group (tests/test_packet_traverse.py), on
    the JAX package's own tables of the port's packed scene."""
    nodes, tris = pk.build_mesh_tables(arrays, meta, traversal="classic")
    S, L = TILE
    leaf_rows = meta.leaf_size // pk._TRI_SLOTS_PER_ROW
    (_, root, end), = meta.group_bvh

    def kernel(node_ref, tri_ref, ox, oy, oz, dx, dy, dz, *outs):
        bt0 = jnp.full((S, L), pk._BIG, jnp.float32)
        act = jnp.ones((S, L), jnp.bool_)
        res = pk._packet_traverse(
            node_ref, tri_ref, leaf_rows, cfg.epsilon, cfg.t_max,
            root, end, ox[...], oy[...], oz[...],
            dx[...], dy[...], dz[...], act, bt0, uniform_color=None)
        for ref, val in zip(outs, res):
            ref[...] = val

    f32 = jax.ShapeDtypeStruct((S, L), jnp.float32)
    outs = pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 8,
        out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 7,
        out_shape=[f32] * 7,
        interpret=True,
    )(jnp.asarray(nodes), jnp.asarray(tris),
      *[jnp.asarray(r.reshape(S, L)) for r in rays])
    return [np.asarray(o).reshape(-1) for o in outs]


def _rays_toward_mesh(arrays, n, seed=0):
    """Random rays aimed into the mesh bounding box (plus some misses)."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(arrays.node_bb_min).min(axis=0)
    hi = np.asarray(arrays.node_bb_max).max(axis=0)
    center = (lo + hi) / 2
    span = (hi - lo).max()
    o = center + rng.normal(size=(n, 3)) * span * 1.5
    tgt = lo + rng.random((n, 3)) * (hi - lo)
    # last quarter aims away from the box: guaranteed misses
    miss = np.arange(n) >= (3 * n) // 4
    d = np.where(miss[:, None], o - center, tgt - o)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _brute_force(arrays, eps, o, d):
    """Closest-hit oracle: Möller–Trumbore over every real triangle."""
    p1 = arrays.tri_p1.numpy()
    e1 = arrays.tri_e1.numpy()
    e2 = arrays.tri_e2.numpy()
    best_t = np.full(o.shape[0], BIG, np.float32)
    best_i = np.full(o.shape[0], -1, np.int64)
    best_u = np.zeros(o.shape[0], np.float32)
    best_v = np.zeros(o.shape[0], np.float32)
    for i in range(p1.shape[0]):
        dxe2 = np.cross(d, e2[i])
        det = dxe2 @ e1[i]
        ok = np.abs(det) >= eps
        f = 1.0 / np.where(ok, det, 1.0)
        p = o - p1[i]
        u = f * (p * dxe2).sum(1)
        q = np.cross(p, e1[i])
        v = f * (q * d).sum(1)
        t = f * (q @ e2[i])
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > eps) \
            & (t < best_t)
        best_t = np.where(hit, t, best_t)
        best_i = np.where(hit, i, best_i)
        best_u = np.where(hit, u, best_u)
        best_v = np.where(hit, v, best_v)
    return best_t, best_i, best_u, best_v


def _port_walk(meta, cfg, tables, o, d, octant, active=None, bt0=None):
    n = o.shape[0]
    (_, root, end), = meta.group_bvh
    rays = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])]
    act = (torch.ones(n, dtype=torch.bool) if active is None
           else torch.from_numpy(active))
    bt = (torch.full((n,), BIG) if bt0 is None else torch.from_numpy(bt0))
    out = mk.traverse_reference(
        *map(torch.from_numpy, tables), meta.leaf_size,
        cfg.epsilon, cfg.t_max, root, end, *rays, act, bt,
        n_nodes=meta.n_nodes if octant else 0)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("octant", [False, True])
def test_walk_matches_packet_walk(octant):
    cfg, arrays, meta, tables = _mesh("teapot")
    o, d = _rays_toward_mesh(arrays, TILE[0] * TILE[1], seed=512)
    want = _packet_interpret(meta, cfg, arrays,
                             [o[:, 0], o[:, 1], o[:, 2],
                              d[:, 0], d[:, 1], d[:, 2]])
    got = _port_walk(meta, cfg, tables, o, d, octant)
    whit, ghit = want[0] < BIG, got[0] < BIG
    assert (whit == ghit).mean() >= 0.999
    assert whit.sum() > o.shape[0] // 4            # the aimed rays hit
    both = whit & ghit
    np.testing.assert_allclose(got[0][both], want[0][both], rtol=1e-5)
    for k in range(1, 4):
        np.testing.assert_allclose(got[k][both], want[k][both], atol=1e-4)
    # colors: the uniform mesh color where hit, zero elsewhere
    for k in range(4, 7):
        assert np.array_equal(got[k][both], want[k][both])
        assert (got[k][~ghit] == 0).all()


@pytest.mark.parametrize("name,octant", [("teapot", True), ("glass", True),
                                         ("default", False),
                                         ("size-check", True)])
def test_walk_matches_brute_force(name, octant):
    cfg, arrays, meta, tables = _mesh(name)
    n = 2048
    o, d = _rays_toward_mesh(arrays, n, seed=7)
    got = _port_walk(meta, cfg, tables, o, d, octant)
    bt, bi, bu, bv = _brute_force(arrays, cfg.epsilon, o, d)
    hit = bi >= 0
    assert ((got[0] < BIG) == hit).mean() >= 0.999
    assert hit.sum() > n // 8
    both = hit & (got[0] < BIG)
    np.testing.assert_allclose(got[0][both], bt[both], rtol=2e-4, atol=2e-5)
    # the smooth normal interpolated at the oracle's hit (ties may pick
    # another triangle of the same t, hence the 99%)
    i, u, v = bi[both], bu[both, None], bv[both, None]
    n1 = arrays.tri_n1.numpy()[i]
    want = (n1 + u * (arrays.tri_n2.numpy()[i] - n1)
            + v * (arrays.tri_n3.numpy()[i] - n1))
    nrm = np.stack(got[1:4], 1)[both]
    assert (np.abs(nrm - want).max(axis=1) < 1e-3).mean() >= 0.99


def test_walk_respects_active_and_prior_best():
    # inactive rays keep bt0; a closer hit among earlier objects (bt0)
    # prunes the walk and is kept
    cfg, arrays, meta, tables = _mesh("teapot")
    n = 1024
    o, d = _rays_toward_mesh(arrays, n, seed=3)
    free = _port_walk(meta, cfg, tables, o, d, True)
    active = np.arange(n) % 3 != 0
    bt0 = np.where(np.arange(n) % 2 == 0, free[0] * 0.5, BIG)
    bt0 = bt0.astype(np.float32)
    got = _port_walk(meta, cfg, tables, o, d, True, active, bt0)
    assert np.array_equal(got[0][~active], bt0[~active])
    keep = active & (np.arange(n) % 2 == 0)
    assert np.array_equal(got[0][keep], bt0[keep])
    rest = active & (np.arange(n) % 2 == 1)
    assert np.array_equal(got[0][rest], free[0][rest])
    assert (got[1][~active] == 0).all()
