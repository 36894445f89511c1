"""The host side of pathtracer_tpu_torch's intersect-only kernel (K5): the
launch built once a scene (megakernel.IntersectTables), the checks a call
still makes, the kernel's output layout and the plain version.

No JAX: the launcher is the port's own. On the card a call checks its
rays, allocates the outputs (intersect_outputs) and makes one ctypes call
(intersect_launch_args); what depends on the scene alone is built by
intersect_tables. These tests hold those constants to the ones the
wrapper built on every call before (the object types, group roots and
ends, the object count, the mesh flag, the leaf size and the node count),
every refusal to what it was, the output views to the kernel's layout
(csrc/megakernel.cu intersect_params: the integers in a buffer of their
own; a scene without groups gets its constant triangle outputs as
stride-0 views) and the launch arguments to
the C entries' signatures. The kernel itself is held on the card
(tests/test_torch_cuda.py) and through the g++ shim (tools/cuda_shim/run.py
isect)."""
import ctypes

import numpy as np
import pytest
import torch

from _torch_scenes import bounce_rays, camera_rays
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scene.shapes import GROUP
from pathtracer_tpu_torch.scenes import get_scene

torch.set_num_threads(2)

CFG = RenderConfig(width=16, height=12, samples=2)


def _scene(name):
    sc = get_scene(name, CFG)
    arrays, meta = sc.pack(device="cpu")
    gen = torch.Generator().manual_seed(3)
    o, d = camera_rays(sc.camera, CFG.width, CFG.height, 2, gen)
    return arrays, meta, o, d


@pytest.mark.parametrize("name", ["reference", "textures", "teapot"])
def test_constants_built_once_equal_the_per_call_ones(name):
    arrays, meta, _, _ = _scene(name)
    tables = mk.intersect_tables(arrays, meta, "cpu")
    assert isinstance(tables, tuple) and len(tables) == 4
    # what intersect_batch built on every call before
    n_obj = len(meta.obj_types)
    roots, ends = [-1] * n_obj, [-1] * n_obj
    for g, r, e in meta.group_bvh:
        roots[g], ends[g] = r, e
    sc = tables.scene
    assert sc.n_obj == n_obj
    assert list(sc.obj_types[:n_obj]) == list(meta.obj_types)
    assert list(sc.group_root[:n_obj]) == roots
    assert list(sc.group_end[:n_obj]) == ends
    assert tables.mesh == (GROUP in meta.obj_types) == meta.has_groups
    assert sc.leaf_size == meta.leaf_size
    assert sc.oct_nodes == (meta.n_nodes if meta.octant_orders else 0)
    assert (sc.obj, sc.nodes, sc.tris, sc.shade) == tuple(
        t.data_ptr() for t in tables)
    assert tables.scene_addr == ctypes.addressof(sc)
    assert tables.meta is meta and tables.device == torch.device("cpu")
    assert tables.walks == {mk.scene_walk(meta)}
    # the four tables index and unpack as before
    obj, nodes, tris, shade = tables
    for a, b in zip((obj, nodes, tris, shade), (
            mk.build_scene_table(arrays, meta),
            *mk.build_mesh_tables(arrays, meta))):
        assert np.array_equal(a.numpy(), b)


def _bad_rays(o, d):
    return {
        "dtype": (o, (d[0].double(), d[1], d[2])),
        "rank": (o, (d[0].reshape(-1, 1), d[1], d[2])),
        "length": (o, (d[0][:-1], d[1], d[2])),
        "device": (o, (torch.empty(d[0].shape, device="meta"), d[1], d[2])),
        "contiguity": ((torch.stack([o[0], o[0]], 1)[:, 0], o[1], o[2]), d),
        "count": (o[:2], d),
    }


@pytest.mark.parametrize("case", ["dtype", "rank", "length", "device",
                                  "contiguity", "count"])
def test_wrong_rays_raise(case):
    arrays, meta, o, d = _scene("teapot")
    tables = mk.intersect_tables(arrays, meta, "cpu")
    oo, dd = _bad_rays(o, d)[case]
    with pytest.raises(ValueError, match="rays must be contiguous f32|"
                                         "3-tuples"):
        mk._check_rays(oo, dd)
    with pytest.raises(ValueError):
        mk.intersect_batch(arrays, meta, CFG, oo, dd, tables=tables)


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "count",
                                  "device"])
def test_wrong_tables_raise(case):
    arrays, meta, o, d = _scene("teapot")
    good = list(mk.intersect_tables(arrays, meta, "cpu"))
    bad = {
        "dtype": [good[0].double(), *good[1:]],
        "shape": [good[0], good[1][:-1], *good[2:]],
        "contiguity": [good[0], good[1], good[2].t().contiguous().t(),
                       good[3]],
        "count": good[:3],
        "device": [good[0], torch.empty(good[1].shape, device="meta"),
                   *good[2:]],
    }[case]
    match = "tables must be" if case == "count" else "must be a contiguous"
    with pytest.raises(ValueError, match=match):
        mk.IntersectTables(bad, meta)
    with pytest.raises(ValueError, match=match):
        mk.intersect_batch(arrays, meta, CFG, o, d, tables=tuple(bad))


def test_walk_knobs_are_read_at_every_call(monkeypatch):
    arrays, meta, o, d = _scene("teapot")
    tables = mk.intersect_tables(arrays, meta, "cpu")
    monkeypatch.setenv("PT_SUBPACKET", "3")
    tables.check(mk.scene_walk(meta), tables.device)
    assert tables.walks == {mk.Walk(), mk.Walk("warp", "simt")}
    # MXU leaves read fragments after the test table's rows: tables built
    # without them are refused on that walk
    monkeypatch.setenv("PT_TRAVERSAL", "mxu")
    with pytest.raises(ValueError, match="tri_table must be"):
        tables.check(mk.scene_walk(meta), tables.device)


def _kernel_layout(res, mesh: bool):
    """The buffers the kernel writes (csrc/megakernel.cu intersect_params),
    filled from a result of intersect_batch's form."""
    t, idx, lo, ld, is_tri, nrm, col, slot = res
    n = t.shape[0]
    f = torch.stack([t, *lo, *ld] + ([*nrm, *col] if mesh else []))
    i = torch.zeros((3 if mesh else 1, n), dtype=torch.int32)
    i[0] = idx
    if mesh:
        i[1] = slot
        i[2].view(torch.uint8)[:n] = is_tri.to(torch.uint8)
    return f, i


@pytest.mark.parametrize("name", ["reference", "textures", "teapot"])
def test_result_views_read_the_kernel_layout(name):
    arrays, meta, o, d = _scene(name)
    tables = mk.intersect_tables(arrays, meta, "cpu")
    want = mk.intersect_batch_reference(arrays, meta, CFG, o, d, tables)
    n = o[0].numel()
    bufs = mk.intersect_outputs(n, tables)
    rows = (13, 3) if meta.has_groups else (7, 1)
    assert [tuple(b.shape) for b in bufs] == [(rows[0], n), (rows[1], n)]
    assert [b.dtype for b in bufs] == [torch.float32, torch.int32]
    for b, v in zip(bufs, _kernel_layout(want, meta.has_groups)):
        b.copy_(v)
    got = mk.intersect_result(bufs, tables)
    flat = [[x for r in res for x in (r if isinstance(r, tuple) else (r,))]
            for res in (got, want)]
    assert len(flat[0]) == 16
    for a, b in zip(*flat):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    # the integers (kept by autograd as an index and a condition) share no
    # storage with the f32 rows
    ptr = bufs[0].untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() != ptr
               for x in (got[1], got[4], got[7]))
    if not meta.has_groups:
        # the triangle outputs are constants without groups: stride-0
        # views of one value, made once for each ray count, on which an
        # in-place write raises
        consts = [got[4], *got[5], *got[6], got[7]]
        assert all(c.stride() == (0,) for c in consts)
        assert mk.intersect_result(bufs, tables)[5][0] is got[5][0]
        for c in consts:
            with pytest.raises(RuntimeError):
                c.add_(1)
        assert int(got[7][0]) == -1 and not bool(got[4].any())


@pytest.mark.parametrize("walk", [mk.Walk(), mk.Walk("warp", "simt"),
                                  mk.Walk("block", "mma")])
def test_launch_args_match_the_entries(monkeypatch, walk):
    arrays, meta, o, d = _scene("teapot")
    if walk.leaf == "mma":
        monkeypatch.setenv("PT_TRAVERSAL", "mxu")
    tables = mk.intersect_tables(arrays, meta, "cpu")
    calls = {}

    class Lib:
        def __getattr__(self, name):
            return lambda *a: calls.setdefault(name, a) and 0

    monkeypatch.setattr(mk, "library", Lib)
    monkeypatch.setattr(mk, "_raw_stream", lambda device: 1234)
    rays = (*o, *d)
    bufs = mk.intersect_outputs(o[0].numel(), tables)
    fn, args = mk.intersect_launch_args(tables, rays, bufs, CFG.epsilon,
                                        CFG.t_max, walk)
    fn(*args)
    entry = ("pt_intersect_launch" if walk == mk.Walk()
             else "pt_intersect_packet_launch")
    assert list(calls) == [entry]
    assert len(args) == len(mk.SIGNATURES[entry][0])
    assert args[:9] == (tables.scene_addr, *(t.data_ptr() for t in rays),
                        *(b.data_ptr() for b in bufs))
    assert args[9:13] == (o[0].numel(), CFG.epsilon, CFG.t_max, 1234)
    if walk != mk.Walk():
        assert args[14:] == (mk.WALK_CODES[walk.walk],
                             mk.LEAF_CODES[walk.leaf])
        assert (args[13] is None) == (walk.leaf != "mma")


@pytest.mark.parametrize("name", ["reference", "teapot"])
def test_plain_version_unchanged(name):
    """The plain version answers the same with the prepared tables and a
    plain 4-tuple of them, on camera rays and one bounce from their hits,
    and counts the walking rays and warps (none without groups)."""
    arrays, meta, o, d = _scene(name)
    tables = mk.intersect_tables(arrays, meta, "cpu")
    counts = {}
    first = mk.intersect_batch_reference(arrays, meta, CFG, o, d, tables,
                                         counts)
    gen = torch.Generator().manual_seed(4)
    o2, d2 = bounce_rays(o, d, first[0], CFG.t_max, gen)
    for oo, dd in ((o, d), (o2, d2)):
        a = mk.intersect_batch(arrays, meta, CFG, oo, dd, tables=tables)
        b = mk.intersect_batch(arrays, meta, CFG, oo, dd,
                               tables=tuple(tables))
        fa = [x for r in a for x in (r if isinstance(r, tuple) else (r,))]
        fb = [x for r in b for x in (r if isinstance(r, tuple) else (r,))]
        assert all(torch.equal(x, y) for x, y in zip(fa, fb))
    n = o[0].numel()
    assert counts["rays"] == n and counts["warps"] == -(-n // 32)
    assert 0 <= counts["walk_rays"] <= n
    assert counts["walk_warps"] <= counts["warps"]
    if meta.has_groups:
        assert counts["walk_rays"] > 0
    else:
        assert counts["walk_rays"] == counts["walk_warps"] == 0
