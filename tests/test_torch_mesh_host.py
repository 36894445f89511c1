"""pathtracer_tpu_torch mesh host layer against pathtracer_tpu: OBJ parsing,
the BVH pool with its octant copies, scene packing, the mesh tables, the
packed tile layout and the chunk-shared draws must equal the JAX package's
exactly.

The JAX package builds BVHs and parses .obj files natively when its
scene-core library is built. That builder is not bit-identical to its own
NumPy one on large meshes (ROADMAP queue 3), and this package always takes
the NumPy path, so the JAX side is packed here with the native library
switched off (`native.available` patched to False).

One reference fault is not inherited: on that NumPy path the group bounds
of every parsed model are NaN (the empty "DefaultGroup" of the .obj is
transformed, 0 * inf), which hides the model from the kernel's bbox
pretest. The port's bounds are the model's vertex bounds; the tests hold
them against those and hand the JAX side the same bounds where its kernel
runs.
"""
import dataclasses
import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu.native as jnative
import pathtracer_tpu.scenes as jscenes
from _torch_parity import jax_fields_np, scene_pair
from _torch_scenes import MESH_SCENES, assert_slot_rule, size_check_scene
from pathtracer_tpu import assets as jassets
from pathtracer_tpu.config import RenderConfig as JaxConfig
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu.scene import objfile as jobj
from pathtracer_tpu_torch import assets as tassets
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scene import Group, from_jax_scene, objfile, shapes
from pathtracer_tpu_torch.scene.bounds import BoundingBox, bounds_of
from pathtracer_tpu_torch.scenes import get_scene

torch.set_num_threads(2)

CPU = torch.device("cpu")
CFG = dict(width=32, height=24, samples=8, samples_per_pass=8)
ALL = MESH_SCENES + ("size-check",)


def _jax_numpy():
    """The JAX package with its native scene-core switched off."""
    return mock.patch.object(jnative, "available", lambda: False)


@functools.lru_cache(maxsize=None)
def _packed(name):
    """(JAX scene, its arrays as numpy, meta, port scene, arrays, meta) for
    a mesh scene or the size-check mesh, the JAX side on its NumPy path."""
    with _jax_numpy():
        if name == "size-check":
            js = size_check_scene(JaxConfig(**CFG), jscenes.get_scene)
            ts = size_check_scene(RenderConfig(**CFG), get_scene)
        else:
            js, _, ts, _ = scene_pair(name, **CFG)
        ja, jm = js.pack()
    ta, tm = ts.pack(device=CPU)
    return js, jax_fields_np(ja), jm, ts, ta, tm


def _vertex_bounds(scene, j):
    tris = scene.objects[j].all_triangles()
    pts = np.stack([p[:3] for t in tris for p in (t.p1, t.p2, t.p3)])
    return (pts.min(0).astype(np.float32), pts.max(0).astype(np.float32))


@pytest.mark.parametrize("name", ALL)
def test_pack_equals_jax_numpy_path(name):
    js, jf, jm, ts, ta, tm = _packed(name)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert tm.has_groups and tm.octant_orders
    assert tm.tri_uniform_color is not None
    for field, want in jf.items():
        got = getattr(ta, field).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, field
        if field in ("bb_min", "bb_max"):
            continue
        if field in ("tri_n1", "tri_n2", "tri_n3"):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=field)
        else:
            assert np.array_equal(got, want), field
    # group bounds: the model's vertex bounds (the JAX NumPy path packs NaN
    # for a parsed model; `default` builds its group in code and is exact)
    for j in tm.group_indices:
        lo, hi = _vertex_bounds(ts, j)
        assert np.array_equal(ta.bb_min[j].numpy(), lo)
        assert np.array_equal(ta.bb_max[j].numpy(), hi)
        jlo, jhi = jf["bb_min"][j], jf["bb_max"][j]
        assert (np.isnan(jlo).all() and np.isnan(jhi).all()) or (
            np.array_equal(jlo, lo) and np.array_equal(jhi, hi))
    others = [i for i in range(jf["bb_min"].shape[0])
              if i not in tm.group_indices]
    assert np.array_equal(ta.bb_min.numpy()[others], jf["bb_min"][others])


@pytest.mark.parametrize("name", ("default", "teapot", "glass",
                                  "size-check"))
def test_bvh_pool_and_mesh_tables_equal_jax(name):
    js, jf, jm, ts, ta, tm = _packed(name)
    nn = tm.n_nodes
    assert ta.node_bb_min.shape[0] == 9 * nn
    # copy 0 is the DFS order; each copy's skip links stay inside it
    for k in range(9):
        ex = ta.node_exit[k * nn:(k + 1) * nn].numpy()
        assert ((ex > np.arange(nn) + k * nn) & (ex <= (k + 1) * nn)).all()
    leaves = ta.node_is_leaf.numpy() == 1
    starts = ta.node_tri_start.numpy()[leaves]
    assert (starts % tm.leaf_size == 0).all()
    assert (starts + tm.leaf_size <= tm.n_tri_slots).all()
    ja = pk.SceneArrays(**{k: jnp.asarray(v) for k, v in jf.items()})
    for got, want in zip(mk.build_mesh_tables(ta, tm),
                         pk.build_mesh_tables(ja, jm)):
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)


def test_size_check_mesh_shape():
    _, _, _, ts, ta, tm = _packed("size-check")
    (j,) = tm.group_indices
    assert len(ts.objects[j].all_triangles()) == 16640
    assert (tm.leaf_size, tm.n_nodes, tm.n_tri_slots) == (16, 2079, 16640)
    assert ta.node_bb_min.shape == (9 * 2079, 3)


def test_model_bounds_are_finite_vertex_bounds():
    # the port's fix: an empty child group adds nothing to the bounds
    g = objfile.parse_obj(tassets.uv_sphere_obj(6, 8)).to_group()
    assert not g.children[0].children             # the empty DefaultGroup
    g.bounds()
    lo, hi = g.bounding_box.min[:3], g.bounding_box.max[:3]
    assert np.isfinite(lo).all() and np.isfinite(hi).all()
    tris = g.all_triangles()
    pts = np.stack([p[:3] for t in tris for p in (t.p1, t.p2, t.p3)])
    assert np.array_equal(lo, pts.min(0)) and np.array_equal(hi, pts.max(0))
    assert BoundingBox.empty().is_empty() and not bounds_of(
        shapes.Sphere()).is_empty()
    # a transformed triangle goes through the eight-corner transform
    t = shapes.Triangle(np.array([0., 0, 0, 1]), np.array([1., 0, 0, 1]),
                        np.array([0., 1, 0, 1]))
    t.set_transform(np.diag([2.0, 3.0, 1.0, 1.0]))
    h = Group()
    h.add_child(t)
    h.bounds()
    assert np.array_equal(h.bounding_box.max[:3], [2.0, 3.0, 0.0])
    assert shapes.flatten(g) == tris


def test_objfile_equals_jax(tmp_path):
    (tmp_path / "m.mtl").write_text(
        "newmtl red\nKa 0.1 0 0\nKd 0.5 0.1 0.1\nKs 0 0 0.2\nNs 10\n"
        "Ni 1.4\nd 0.75\n")
    text = "\n".join([
        "mtllib m.mtl", "v 0 0 0", "v 1 0 0", "v 1 1 0", "v 0 1 0.5",
        "vn 0 0 1", "vn 0 1 0", "g quad", "usemtl red",
        "f 1//1 2//1 3//2 4//2", "g plain", "f 1 2 3", "o other",
        "f 2 3 4", "# comment"])
    assert tassets.uv_sphere_obj(5, 7) == jassets.uv_sphere_obj(5, 7)
    assert tassets.goblet_obj(6) == jassets.goblet_obj(6)
    for src in (text, tassets.uv_sphere_obj(5, 7), tassets.goblet_obj(6)):
        got = objfile.parse_obj(src, mtl_dir=str(tmp_path))
        want = jobj.parse_obj(src, mtl_dir=str(tmp_path))
        assert got.group_order == want.group_order
        assert got.ignored_lines == want.ignored_lines
        gt, wt = got.all_triangles(), want.all_triangles()
        assert len(gt) == len(wt) > 0
        objfile.compute_vertex_normals(gt)
        jobj.compute_vertex_normals(wt)
        for a, b in zip(gt, wt):
            for f in ("p1", "p2", "p3", "e1", "e2", "n", "n1", "n2", "n3"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), f
            assert dataclasses.asdict(a.material) == \
                dataclasses.asdict(b.material)
    mtl = (tmp_path / "m.mtl").read_text()
    assert {k: dataclasses.asdict(v) for k, v in
            objfile.parse_mtl(mtl).items()} == \
        {k: dataclasses.asdict(v) for k, v in jobj.parse_mtl(mtl).items()}


def test_asset_fallbacks_equal_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("PT_ASSETS", str(tmp_path))
    (tmp_path / "x.obj").write_text("v 0 0 0\n")
    assert tassets.find_asset("x.obj") == jassets.find_asset("x.obj")
    for name in ("teapot.obj", "gopher.obj", "glass.obj", "x.obj"):
        assert tassets.load_obj_source(name) == jassets.load_obj_source(name)
    assert tassets.asset_search_paths()[:2] == \
        jassets.asset_search_paths()[:2]


@pytest.mark.parametrize("env", [
    {"PT_BVH_LEAF": "8"}, {"PT_BVH_LEAF": "16"}, {"PT_OCTANT": "0"}])
def test_pack_knobs_equal_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with _jax_numpy():
        js, _, ts, _ = scene_pair("teapot", **CFG)
        ja, jm = js.pack()
    ta, tm = ts.pack(device=CPU)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert tm.leaf_size == int(env.get("PT_BVH_LEAF", 32))
    assert tm.octant_orders == ("PT_OCTANT" not in env)
    for field, want in jax_fields_np(ja).items():
        if field not in ("bb_min", "bb_max"):
            assert np.array_equal(getattr(ta, field).numpy(), want), field
    assert mk.build_mesh_tables(ta, tm)[0].shape[0] == \
        tm.n_nodes * (9 if tm.octant_orders else 1)


@pytest.mark.parametrize("env", [
    {}, {"PT_SPP_PACK": "2"}, {"PT_SPP_PACK": "16"}, {"PT_PACK_AXIS": "row"},
    {"PT_PACK_AXIS": "row", "PT_SPP_PACK": "4"}, {"PT_TILE_ORDER": "linear"},
])
def test_mesh_layout_knobs_equal_jax(monkeypatch, env):
    # the driver's mesh layout: tile (8, 512), block order, 4 replicas on
    # the lane chunks by default (8 clamped to 512 / 128)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _, _, _, _, _, tm = _packed("teapot")
    assert mk.default_tile(tm) == pk.default_tile(tm) == (8, 512)
    assert mk.default_order(tm) == pk.default_order(tm)
    axis = mk.default_pack_axis(tm)
    assert axis == pk.default_pack_axis(tm)
    for spp in (None, 1, 6, 8, 2048):
        assert mk.default_pack(tm, spp) == pk.default_pack(tm, spp)
    pack = mk.clamp_pack(mk.default_pack(tm, 8), 8, 512, axis)
    assert pack == pk.clamp_pack(pk.default_pack(tm, 8), 8, 512, axis)
    if not env:
        assert (pack, axis, mk.default_order(tm)) == (4, "chunk", "block")


@pytest.mark.parametrize("order", ("linear", "block", "subblock", "rowblock"))
@pytest.mark.parametrize("W,H,S,L,pack,axis,granule", [
    (32, 24, 8, 512, 4, "chunk", 1),      # the mesh default
    (100, 37, 8, 512, 2, "chunk", 2),
    (160, 120, 8, 256, 2, "chunk", 1),
    (32, 24, 8, 512, 2, "row", 1),
    (100, 37, 8, 128, 8, "row", 3),       # padding with whole dummy tiles
])
def test_packed_layout_and_untile_equal_jax(order, W, H, S, L, pack, axis,
                                            granule):
    got = mk.tile_pixel_layout(W, H, S, L, shard_granule=granule,
                               order=order, spp_pack=pack, pack_axis=axis)
    want = pk.tile_pixel_layout(W, H, S, L, shard_granule=granule,
                                order=order, spp_pack=pack, pack_axis=axis)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    pid = got[2]
    # every pixel appears once per replica
    counts = np.bincount(pid[pid >= 0], minlength=W * H)
    assert (counts == pack).all()
    flat = np.random.default_rng(1).random((pid.size, 3)).astype(np.float32)
    assert np.array_equal(mk.untile_image(flat, pid, W, H),
                          pk.untile_image(flat, pid, W, H))


def test_packed_layout_refuses_bad_packs():
    with pytest.raises(ValueError, match="128-lane"):
        mk.tile_pixel_layout(32, 24, 8, 512, spp_pack=8, pack_axis="chunk")
    with pytest.raises(ValueError, match="divide S"):
        mk.tile_pixel_layout(32, 24, 8, 512, spp_pack=3, pack_axis="row")


@pytest.mark.parametrize("shape,cw", [((8, 512), 128), ((8, 128), 128),
                                      ((4, 256), 256)])
@pytest.mark.parametrize("seed,tile,did,n,b", [
    (0, 0, 2, 0, 0), (7919 * 5 + 17, 74, 4, 3, 9),
    (2 ** 31 - 1, 2 ** 20, 5, 2 ** 16 + 1, 2 ** 10)])
def test_uniform_chunk_bit_equal_jax(monkeypatch, shape, cw, seed, tile, did,
                                     n, b):
    monkeypatch.setattr(pk, "_SW_PRNG", True)
    pk._prng_seed(jnp.int32(seed), jnp.int32(tile))
    want = np.asarray(pk._uniform_chunk(shape, cw, did, jnp.int32(n),
                                        jnp.int32(b)))
    got = mk._uniform_chunk(mk._prng_key(seed, tile), shape, cw, did, n, b)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    # the kernel's per-slot element rule picks the same draws
    S, L = shape
    r0 = torch.arange(S).reshape(S, 1).expand(S, L)
    lane = torch.arange(L).reshape(1, L).expand(S, L)
    elem = mk._coherent_elem(r0, lane, L, "chunk")
    if cw == 128:
        rule = mk._hash_uniform(mk._prng_key(seed, tile), elem, did, n, b)
        assert np.array_equal(rule.numpy(), want)


def test_from_jax_scene_carries_teapot():
    js, jf, jm, ts, ta, tm = _packed("teapot")
    # the JAX NumPy path's NaN group bounds are refused, not carried
    with pytest.raises(ValueError, match="group bounds"):
        from_jax_scene(jf, jm, CPU)
    fixed = dict(jf, bb_min=ta.bb_min.numpy(), bb_max=ta.bb_max.numpy())
    fa, fm = from_jax_scene(fixed, jm, CPU)
    assert fm == tm and fm.group_bvh == tm.group_bvh
    for field in ta._fields:
        if field.startswith("tri_n"):
            assert torch.allclose(getattr(fa, field), getattr(ta, field),
                                  rtol=0, atol=1e-6), field
        else:
            assert torch.equal(getattr(fa, field), getattr(ta, field)), field
    cfg = RenderConfig(**CFG)
    got = mk.render_megakernel(fa, fm, ts.camera, cfg)
    want = mk.render_megakernel(ta, tm, ts.camera, cfg)
    assert got.shape == (24, 32, 3) and np.isfinite(got).all()
    assert_slot_rule(np.moveaxis(got, -1, 0), np.moveaxis(want, -1, 0))


@pytest.mark.parametrize("env,walk", [
    ({"PT_TRAVERSAL": "mxu"}, ("block", "mma")),
    ({"PT_SUBPACKET": "1"}, ("block", "simt")),
    ({"PT_SUBPACKET": "2"}, ("block", "simt")),
    ({"PT_SUBPACKET": "3"}, ("warp", "simt")),
    ({"PT_ABLATE_LEAF": "1"}, ("thread", "none"))])
def test_unported_mesh_knobs_raise(monkeypatch, env, walk):
    # the knobs of the TPU's sub-packet gating, per-chunk walks, MXU leaf
    # machine and leaf ablation no longer raise: each selects the
    # kernel's walk of its counterpart, whose plain version renders the
    # teapot as the per-thread walk does (the node walk alone sees through
    # it)
    _, _, _, ts, ta, tm = _packed("teapot")
    cfg = RenderConfig(**CFG)
    xs, ys, _ = mk.tile_pixel_layout(32, 24, 8, 512, order="block",
                                     spp_pack=4, pack_axis="chunk")

    def render():
        tabs = [torch.from_numpy(t) for t in (
            mk.build_camera_vec(ts.camera), mk.build_scene_table(ta, tm),
            *mk.build_mesh_tables(ta, tm), xs, ys)]
        return torch.stack(mk.trace_tiles(
            (0, 0), *tabs, meta=tm, cfg=cfg, spp=8, total_samples=8,
            tile=(8, 512), spp_pack=4, pack_axis="chunk")).numpy()

    classic = render()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert mk.mesh_walk() == mk.Walk(*walk)
    got = render()
    assert np.isfinite(got).all()
    if walk[1] == "none":
        assert np.abs(got - classic).mean() > 1e-3
    else:
        assert np.abs(got - classic).mean() < 1e-4
    if "PT_TRAVERSAL" in env:
        # the MXU blocks ride after the classic rows of the triangle table
        tris = mk.build_mesh_tables(ta, tm)[1]
        classic_rows = -(-tm.n_tri_slots // 4)
        assert tris.shape[0] == classic_rows + mk._mxu_rows(tm)
    # primitive scenes do not read the mesh knobs, as in the JAX package
    ra, rm = get_scene("reference", cfg).pack(device=CPU)
    assert mk.build_mesh_tables(ra, rm)[0].shape == (1, 16)
