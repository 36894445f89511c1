"""The port's mesh tables and its narrowed object loop.

The tables (render/megakernel.py build_mesh_tables) are 16-byte records: a
node is two float4 (bbmin and a leaf's first slot, -1 for an inner node;
bbmax and the exit), a triangle slot a test record (p1, Ng, U, V) and, in
an array of its own, a shading record (n1, n2-n1, n3-n1, color). They must
hold SceneArrays' fields exactly; the plain walk over them must find, ray
by ray, the JAX package's packet walk's winning slot in its interpret-mode
harness (tests/test_torch_mesh_walk.py's, with a probe payload whose smooth
normal is (u, v, 0)), its t within 1e-6 relative and (u, v) within 1e-4
(XLA:CPU fuses the JAX walk's multiply-adds); the triangle-color parameter
rewrites the shading array alone.

The object loop (_nearest_hit, and csrc/megakernel.cu's nearest_hit)
transforms for each test only what it reads (a plane its y row) and the
winner's whole ray once after the loop: the same operations on the same
inputs as a loop that carries every object's transformed ray, so every
output bit for bit, on random rays over planes, spheres, a cylinder, a box
and a GROUP, and with a GROUP light for the shadow query.

The port packs a mesh at leaf 4 (scene/pack.py leaf_size_for), the JAX
package at 32 or 16: at the same PT_BVH_LEAF the two agree per slot, a
render and a triangle-gradient step alike.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import pathtracer_tpu.native as jnative
from _torch_parity import (assert_inputs_match, jax_pack, kernel_pair,
                           scene_pair)
from _torch_scenes import assert_slot_rule, cylinder_scene, size_check_scene
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu.render.pallas_grad import grad_tiles as jax_grad_tiles
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.geometry import transforms as gx
from pathtracer_tpu_torch.render import grad as tg
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scene import material, pack, shapes
from pathtracer_tpu_torch.scene.shapes import GROUP
from pathtracer_tpu_torch.scenes import cornell, get_scene

torch.set_num_threads(2)

CPU = torch.device("cpu")
CFG = RenderConfig(width=16, height=12, samples=1, samples_per_pass=1)
TILE = (8, 512)
BIG = mk._BIG
EPS, T_MAX = CFG.epsilon, CFG.t_max


@functools.lru_cache(maxsize=None)
def _packed(name):
    sc = (size_check_scene(CFG, get_scene) if name == "size-check"
          else get_scene(name, CFG))
    return sc.pack(device=CPU)


def _np32(t):
    return np.asarray(t.numpy(), dtype=np.float32)


@pytest.mark.parametrize("name", ("teapot", "glass", "default",
                                  "size-check"))
def test_tables_hold_the_scene_fields(name):
    arrays, meta = _packed(name)
    nodes, tris, shade = mk.build_mesh_tables(arrays, meta)
    # 16-byte records, row after row: the kernel's float4 loads
    for table, cols in ((nodes, 8), (tris, 12), (shade, 12)):
        assert table.dtype == np.float32 and table.flags.c_contiguous
        assert table.shape[1] == cols and table.strides[0] % 16 == 0
    leaf = arrays.node_is_leaf.numpy() > 0.5
    assert np.array_equal(nodes[:, 0:3], _np32(arrays.node_bb_min))
    assert np.array_equal(nodes[:, 4:7], _np32(arrays.node_bb_max))
    assert np.array_equal(nodes[:, 7], _np32(arrays.node_exit))
    assert np.array_equal(nodes[leaf, 3], _np32(arrays.node_tri_start)[leaf])
    assert (nodes[~leaf, 3] == -1.0).all() and (nodes[leaf, 3] >= 0).all()
    e1, e2 = _np32(arrays.tri_e1), _np32(arrays.tri_e2)
    ng = np.cross(e1, e2)
    l2 = (ng * ng).sum(axis=1, keepdims=True)
    ok = l2 > 0.0
    safe = np.where(ok, l2, 1.0)
    assert tris.shape[0] == shade.shape[0] == meta.n_tri_slots
    assert np.array_equal(tris[:, 0:3], _np32(arrays.tri_p1))
    assert np.array_equal(tris[:, 3:6], ng)
    assert np.array_equal(tris[:, 6:9], np.where(ok, np.cross(e2, ng) / safe,
                                                 0.0).astype(np.float32))
    assert np.array_equal(tris[:, 9:12], np.where(ok, np.cross(ng, e1) / safe,
                                                  0.0).astype(np.float32))
    n1 = _np32(arrays.tri_n1)
    assert np.array_equal(shade[:, 0:3], n1)
    assert np.array_equal(shade[:, 3:6], _np32(arrays.tri_n2) - n1)
    assert np.array_equal(shade[:, 6:9], _np32(arrays.tri_n3) - n1)
    assert np.array_equal(shade[:, 9:12], _np32(arrays.tri_color))


def test_triangle_colors_rewrite_the_shading_table_alone(monkeypatch):
    arrays, meta = _packed("teapot")
    nodes, tris, shade = (torch.from_numpy(t)
                          for t in mk.build_mesh_tables(arrays, meta))
    rng = np.random.default_rng(5)
    colors = torch.from_numpy(rng.random((meta.n_tri_slots, 3),
                                         dtype=np.float32))
    got = tg._assemble_tri(shade, colors)
    assert torch.equal(got[:, :9], shade[:, :9])
    assert torch.equal(got[:, 9:], colors) and got.is_contiguous()
    # the triangle-color render hands the kernel its node and test tables
    # as they are, and the shading table rebuilt
    seen = {}

    def capture(seed, cam, obj, n, t, s, px, py, **kw):
        seen.update(nodes=n, tris=t, shade=s)
        return (torch.zeros(px.shape),) * 3

    monkeypatch.setattr(mk, "trace_tiles", capture)
    render = tg.make_diff_render_tri(meta, CFG, 1, TILE)
    px = torch.zeros(TILE, dtype=torch.int32)
    obj = torch.from_numpy(mk.build_scene_table(arrays, meta))
    render.apply(arrays.color, arrays.emission, colors, (1, 0),
                 torch.zeros(17), obj, nodes, tris, shade, px, px)
    assert seen["nodes"] is nodes and seen["tris"] is tris
    assert torch.equal(seen["shade"], got)


def _probe_payload(arrays, meta):
    """The JAX package's classic tables of the scene, and the port's, with
    each slot's normals replaced by n1 = 0, n2 - n1 = (1, 0, 0), n3 - n1 =
    (0, 1, 0): a walk's smooth normal is then its winner's (u, v, 0)."""
    jn, jt = pk.build_mesh_tables(arrays, meta, traversal="classic")
    nodes, tris, shade = mk.build_mesh_tables(arrays, meta)
    probe = np.zeros(9, np.float32)
    probe[3], probe[7] = 1.0, 1.0
    slots = jt.reshape(-1, 24).copy()
    slots[:, 12:21] = probe
    shade = shade.copy()
    shade[:, 0:9] = probe
    return (jn, slots.reshape(jt.shape)), (nodes, tris, shade)


def _jax_walk(meta, jtabs, rays):
    """pk._packet_traverse with return_slot in an interpret-mode
    pallas_call on copy 0 of the single group (tests/test_torch_mesh_walk.py
    's harness): (t, u, v, slot) of each ray."""
    S, L = TILE
    (_, root, end), = meta.group_bvh

    def kernel(node_ref, tri_ref, ox, oy, oz, dx, dy, dz, *outs):
        res = pk._packet_traverse(
            node_ref, tri_ref, meta.leaf_size // pk._TRI_SLOTS_PER_ROW, EPS,
            T_MAX, root, end, ox[...], oy[...], oz[...], dx[...], dy[...],
            dz[...], jnp.ones((S, L), jnp.bool_),
            jnp.full((S, L), pk._BIG, jnp.float32), return_slot=True)
        t, u, v, slot = res[0], res[1], res[2], res[-1]
        for ref, val in zip(outs, (t, u, v, slot)):
            ref[...] = val

    f32 = jax.ShapeDtypeStruct((S, L), jnp.float32)
    outs = pl.pallas_call(
        kernel, in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 8,
        out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 4,
        out_shape=[f32] * 4, interpret=True,
    )(*map(jnp.asarray, jtabs), *[jnp.asarray(r.reshape(S, L)) for r in rays])
    return [np.asarray(o).reshape(-1) for o in outs]


def _mesh_rays(arrays, n, seed):
    """Rays aimed into the mesh's box from around it, the last quarter
    aimed away (tests/test_torch_mesh_walk.py's)."""
    rng = np.random.default_rng(seed)
    lo = arrays.node_bb_min.numpy().min(axis=0)
    hi = arrays.node_bb_max.numpy().max(axis=0)
    center = (lo + hi) / 2
    o = center + rng.normal(size=(n, 3)) * (hi - lo).max() * 1.5
    tgt = lo + rng.random((n, 3)) * (hi - lo)
    d = np.where((np.arange(n) >= 3 * n // 4)[:, None], o - center, tgt - o)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return [np.ascontiguousarray(a, dtype=np.float32) for a in (*o.T, *d.T)]


@pytest.mark.parametrize("name", ("teapot", "size-check"))
def test_plain_walk_matches_the_jax_walk(name):
    arrays, meta = _packed(name)
    jtabs, tables = _probe_payload(arrays, meta)
    rays = _mesh_rays(arrays, TILE[0] * TILE[1], seed=21)
    want_t, want_u, want_v, want_slot = _jax_walk(meta, jtabs, rays)
    (_, root, end), = meta.group_bvh
    n = rays[0].size
    t, u, v, _, _, _, _, slot = mk.traverse_reference(
        *map(torch.from_numpy, tables), meta.leaf_size, EPS, T_MAX, root,
        end, *map(torch.from_numpy, rays), torch.ones(n, dtype=torch.bool),
        torch.full((n,), BIG), return_slot=True)
    # the same winner on every ray; t, u, v within a few ulps (XLA:CPU
    # contracts the JAX walk's multiply-adds into FMAs)
    hit = want_t < BIG
    assert hit.sum() > n // 4
    assert np.array_equal(t.numpy() < BIG, hit)
    assert np.array_equal(slot.numpy()[hit], want_slot[hit].astype(np.int64))
    assert (slot.numpy()[~hit] == -1).all()
    np.testing.assert_allclose(t.numpy()[hit], want_t[hit], rtol=1e-6)
    np.testing.assert_allclose(u.numpy()[hit], want_u[hit], atol=1e-4)
    np.testing.assert_allclose(v.numpy()[hit], want_v[hit], atol=1e-4)


def _five_types_scene():
    """The closed cylinder and glass cube scene (planes, a sphere light, a
    cylinder, a box) with `teapot`'s model group added, emissive: a GROUP
    light."""
    sc = cylinder_scene(CFG, gx, material, shapes, pack, cornell)
    group = get_scene("teapot", CFG).objects[6]
    assert group.type_code == GROUP
    group.material.emission = (2.0, 2.0, 2.0)
    sc.objects = sc.objects + [group]
    return sc


def _full_transform_nearest_hit(obj, meta, tables, ox, oy, oz, dx, dy, dz):
    """The object loop that transforms the whole ray for every object and
    carries each closer object's transformed ray (the JAX kernels' loop),
    with _nearest_hit's tests, walk and outputs."""
    group_bvh = {g: (r, e) for g, r, e in meta.group_bvh}
    best_t = torch.full_like(ox, BIG)
    w = torch.zeros(ox.shape, dtype=torch.int64)
    loc = [ox, oy, oz, dx, dy, dz]
    on_tri = torch.zeros_like(ox, dtype=torch.bool)
    tri_slot = torch.full_like(w, -1)
    tri = [torch.zeros_like(ox) for _ in range(6)]
    active = torch.ones_like(on_tri)
    for j, code in enumerate(meta.obj_types):
        m = obj[j]
        tloc = (*mk._mat12_point(m, ox, oy, oz), *mk._mat12_vec(m, dx, dy, dz))
        g = None
        if code != GROUP:
            t_j = mk._primitive_t(code, m, EPS, *tloc)
        else:
            pre = active & mk._group_pretest(m, EPS, *tloc, best_t)
            t_j, *g, g_slot = mk.traverse_reference(
                *tables, meta.leaf_size, EPS, T_MAX, *group_bvh[j], *tloc,
                pre, best_t, n_nodes=meta.n_nodes, return_slot=True)
        closer = t_j < best_t
        best_t = torch.where(closer, t_j, best_t)
        w = torch.where(closer, j, w)
        loc = [torch.where(closer, a, b) for a, b in zip(tloc, loc)]
        on_tri = torch.where(closer, g is not None, on_tri)
        if g is not None:
            tri_slot = torch.where(closer, g_slot, tri_slot)
            tri = [torch.where(closer, a, b) for a, b in zip(g, tri)]
    return best_t, w, loc, on_tri, tri_slot, tri[:3], tri[3:]


def _random_rays(n, seed):
    """Rays from random points of the Cornell box in random directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.45, 0.45, (n, 3))
    d = rng.normal(size=(n, 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
            for a in (*o.T, *d.T)]


def test_narrowed_object_loop_is_bit_equal_to_the_full_transform():
    sc = _five_types_scene()
    arrays, meta = sc.pack(device=CPU)
    assert {0, 1, 2, 3, GROUP} <= set(meta.obj_types)
    obj = mk.build_scene_table(arrays, meta).tolist()
    tables = [torch.from_numpy(t) for t in mk.build_mesh_tables(arrays, meta)]
    rays = _random_rays(20000, 8)
    got = mk._nearest_hit(obj, meta, *tables, EPS, T_MAX, *rays,
                          torch.ones_like(rays[0], dtype=torch.bool), 0)
    want = _full_transform_nearest_hit(obj, meta, tables, *rays)
    flat = lambda r: [x for y in r for x in (y if isinstance(y, list)  # noqa
                                             else [y])]
    assert len(flat(got)) == len(flat(want)) == 16
    for a, b in zip(flat(got), flat(want)):
        assert torch.equal(a, b)
    # every type wins some rays, the group (its triangles) too
    for j in range(len(meta.obj_types)):
        assert (got[1] == j).any(), j
    assert got[3].any()


def test_narrowed_shadow_query_keeps_the_rule_with_a_group_light():
    sc = _five_types_scene()
    arrays, meta = sc.pack(device=CPU)
    obj = mk.build_scene_table(arrays, meta).tolist()
    tables = [torch.from_numpy(t) for t in mk.build_mesh_tables(arrays, meta)]
    l = len(meta.obj_types) - 1
    assert meta.obj_types[l] == GROUP
    rays = _random_rays(20000, 9)
    cast = torch.ones_like(rays[0], dtype=torch.bool)
    s_t, s_w, *_ = _full_transform_nearest_hit(obj, meta, tables, *rays)
    want = (s_w == l) & (s_t > EPS) & (s_t < T_MAX)
    got, t_l = mk._light_visible(obj, meta, *tables, EPS, T_MAX, *rays,
                                 cast, l)
    assert want.sum() > 100
    assert torch.equal(got, want) and torch.equal(t_l[want], s_t[want])


# ---- the leaf size: the port's (4) against the JAX package at the same --

def test_render_at_the_port_leaf_matches_jax(monkeypatch):
    # the port packs a mesh at leaf 4 (pack.leaf_size_for); the JAX
    # kernel in interpret mode, packed at the same PT_BVH_LEAF, gives the
    # same slot sums by the per-slot rule
    monkeypatch.setenv("PT_BVH_LEAF", "4")
    got, want, tm = kernel_pair("teapot", TILE, spp=4, W=32, H=24)
    assert tm.leaf_size == 4 and tm.has_groups
    assert_slot_rule(got, want)


def test_triangle_gradients_at_the_port_leaf_match_jax(monkeypatch):
    # one K6 triangle-mode step at leaf 4 against the JAX kernel in
    # interpret mode at the same leaf (tests/test_torch_grad_tri.py's
    # rule: gcol, gemi within 1e-3 of max|g|, 99% of the triangle slots)
    monkeypatch.setenv("PT_BVH_LEAF", "4")
    W, H, spp = 128, 96, 2
    with mock.patch.object(jnative, "available", lambda: False):
        js, jc, ts, tc = scene_pair("teapot", width=W, height=H,
                                    samples=spp, samples_per_pass=spp)
        ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device=CPU)
    assert tm.leaf_size == jm.leaf_size == 4
    ja = ja._replace(bb_min=jnp.asarray(ta.bb_min.numpy()),
                     bb_max=jnp.asarray(ta.bb_max.numpy()))
    xs, ys, _ = mk.tile_pixel_layout(W, H, 8, 128, order=mk.default_order(tm))
    jt = [pk.build_camera_vec(js.camera), pk.build_scene_table(ja, jm),
          *pk.build_mesh_tables(ja, jm), xs, ys]
    tt = [mk.build_camera_vec(ts.camera), mk.build_scene_table(ta, tm),
          *mk.build_mesh_tables(ta, tm), xs, ys]
    assert_inputs_match(jt, tt, tm)
    rng = np.random.default_rng(4)
    cots = [rng.random(xs.shape).astype(np.float32) for _ in range(3)]
    want = jax_grad_tiles(
        jnp.asarray((9, 0), jnp.int32), *map(jnp.asarray, jt),
        *map(jnp.asarray, cots),
        meta=dataclasses.replace(jm, tri_uniform_color=None), cfg=jc,
        spp=spp, total_samples=spp, tile=(8, 128), tri_grads=True,
        interpret=True)
    got = tg.grad_tiles((9, 0), *map(torch.from_numpy, tt),
                        *map(torch.from_numpy, cots), meta=tm, cfg=tc,
                        spp=spp, total_samples=spp, tile=(8, 128),
                        tri_grads=True)
    want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in got]
    for g, w in zip(got[:2], want[:2]):
        assert np.abs(g - w).max() / np.abs(w).max() < 1e-3
    w, g = want[2], got[2]
    assert (np.abs(w) > 0).any(axis=1).sum() >= 20   # the mesh is on screen
    close = (np.abs(g - w) <= 1e-3 * np.abs(w).max()).all(axis=1)
    assert close.mean() >= 0.99
