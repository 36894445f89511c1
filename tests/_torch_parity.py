"""Helpers that build the same scene in pathtracer_tpu (JAX) and
pathtracer_tpu_torch and hand both the same inputs."""
from __future__ import annotations

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pathtracer_tpu.native as jnative
import pathtracer_tpu.scenes as jscenes
import pathtracer_tpu_torch.scenes as tscenes
from _torch_scenes import (assert_slot_rule, cylinder_scene, port_inputs,
                           textured_teapot)
from pathtracer_tpu import config as jconfig
from pathtracer_tpu.render import pallas_grad as jgrad
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu.render import proctex as jproctex
from pathtracer_tpu.geometry import transforms as jgx
from pathtracer_tpu.scene import material as jmat
from pathtracer_tpu.scene import bounds as jbounds
from pathtracer_tpu.scene import pack as jpack
from pathtracer_tpu.scene import shapes as jshapes
from pathtracer_tpu.scenes import cornell as jcornell
from pathtracer_tpu_torch import config as tconfig
from pathtracer_tpu_torch.diff import from_jax_params
from pathtracer_tpu_torch.geometry import transforms as tgx
from pathtracer_tpu_torch.render import grad as tg
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.render import proctex as tproctex
from pathtracer_tpu_torch.scene import material as tmat
from pathtracer_tpu_torch.scene import pack as tpack
from pathtracer_tpu_torch.scene import shapes as tshapes
from pathtracer_tpu_torch.scenes import cornell as tcornell


def port_scene(name: str, **cfg_kw):
    """(torch scene, torch cfg): scene_pair's port half alone, for a test
    that needs no JAX twin (no JAX scene is built, so nothing depends on
    the JAX package's native scene core)."""
    tc = tconfig.RenderConfig(**cfg_kw)
    if name == "cylinder":
        return cylinder_scene(tc, tgx, tmat, tshapes, tpack, tcornell), tc
    return tscenes.get_scene(name, tc), tc


def scene_pair(name: str, **cfg_kw):
    """(JAX scene, JAX cfg, torch scene, torch cfg) for a slice scene or
    the synthetic "cylinder" scene (closed cylinder + glass cube). A mesh
    scene's JAX half depends on whether the JAX native scene core loaded
    in this process: compare the two halves through jax_twin."""
    jc = jconfig.RenderConfig(**cfg_kw)
    if name == "cylinder":
        js = cylinder_scene(jc, jgx, jmat, jshapes, jpack, jcornell)
    else:
        js = jscenes.get_scene(name, jc)
    return (js, jc, *port_scene(name, **cfg_kw))


def jax_pack(js, ts, **kw):
    """The JAX package's pack of scene js at the BVH leaf size the port
    packs its twin ts at (scene.pack.leaf_size_for: PT_BVH_LEAF, else the
    port's rule), on its NumPy path (native scene-core off: the port
    builds its BVH as that path does), so both walk the same slots."""
    with mock.patch.object(jnative, "available", lambda: False):
        return js.pack(leaf_size=tpack.leaf_size_for(ts.objects), **kw)


def jax_twin(name: str, edit=None, **cfg_kw):
    """scene_pair(name, **cfg_kw) and the JAX pack of its JAX half
    (jax_pack), both built with the JAX native scene core switched off:
    whether that library loaded in this process (it is built on first use,
    and parallel test workers race for it) changes the JAX half's .obj
    parse and BVH, so every comparison builds on the NumPy path, as the
    port does. The JAX arrays carry the port's group bounds
    (carry_group_bounds). `edit(scene, is_jax)` changes each half before
    packing (e.g. _torch_scenes.textured_teapot). Returns (JAX scene, JAX
    cfg, JAX arrays, JAX meta, torch scene, torch cfg)."""
    with mock.patch.object(jnative, "available", lambda: False):
        js, jc, ts, tc = scene_pair(name, **cfg_kw)
        if edit is not None:
            js, ts = edit(js, True), edit(ts, False)
        ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device="cpu")
    return js, jc, carry_group_bounds(js, ja, ta, tm), jm, ts, tc


def textured_teapot_twin(sc, is_jax: bool):
    """jax_twin's edit for _torch_scenes.textured_teapot, with each
    package's checkers."""
    return textured_teapot(sc, jproctex.make if is_jax else tproctex.make)


def carry_group_bounds(js, ja, ta, tm):
    """The JAX arrays `ja` of scene `js` with the port's group bounds (its
    arrays `ta`, meta `tm`), after holding each group row to them: equal,
    or NaN on the JAX side where the port's row is the box of the group's
    children with the empty ones left empty. The JAX NumPy path turns an
    empty child's infinite box (a parsed model's empty DefaultGroup) into
    NaN (ROADMAP §3, "NaN group bounds"); the port keeps it empty, so it
    adds nothing, and the row is the JAX package's own merge of the other
    children's parent-space boxes. The kernels' inputs then agree."""
    want_min = np.asarray(ja.bb_min).copy()
    want_max = np.asarray(ja.bb_max).copy()
    for j in tm.group_indices:
        port = (ta.bb_min[j].numpy(), ta.bb_max[j].numpy())
        jax_row = (want_min[j], want_max[j])
        if np.isnan(jax_row).any():
            box = jbounds.BoundingBox.empty()
            for child in js.objects[j].children:
                if not isinstance(child, jshapes.Group) or child.children:
                    box.merge_with(jbounds.parent_space_bounds(child))
            jax_row = (box.min[:3].astype(np.float32),
                       box.max[:3].astype(np.float32))
        for a, b in zip(port, jax_row):
            assert np.array_equal(a, b), (j, port, jax_row)
        want_min[j], want_max[j] = port
    return ja._replace(bb_min=jnp.asarray(want_min),
                       bb_max=jnp.asarray(want_max))


def assert_mesh_tables_match(got, want, meta) -> None:
    """The port's mesh tables (build_mesh_tables: nodes [Nn, 8], triangle
    test [Ns, 12] and shading [Ns, 12] records) hold the JAX package's
    (nodes [Nn, 16]: bbmin, bbmax, tri_start, is_leaf, exit; triangles
    [ceil(Ns/4), 96]: four 24-float slots a row, test then shading data)
    exactly, with a leaf's first slot in node column 3 and -1 there for an
    inner node."""
    nodes, tris, shade = (np.asarray(t) for t in got)
    jn, jt = (np.asarray(t) for t in want)
    assert nodes.dtype == tris.dtype == shade.dtype == np.float32
    if not meta.has_groups:     # no mesh: one zero row each
        assert not (jn.any() or jt.any() or nodes.any() or tris.any()
                    or shade.any())
        assert (nodes.shape, tris.shape, shade.shape) == ((1, 8), (1, 12),
                                                          (1, 12))
        return
    assert nodes.shape == (jn.shape[0], 8) and nodes.flags.c_contiguous
    assert np.array_equal(nodes[:, 0:3], jn[:, 0:3])
    assert np.array_equal(nodes[:, 4:7], jn[:, 3:6])
    assert np.array_equal(nodes[:, 7], jn[:, 8])
    assert np.array_equal(nodes[:, 3], np.where(jn[:, 7] > 0.5, jn[:, 6],
                                                -1.0))
    slots = jt.reshape(-1, 24)
    n = meta.n_tri_slots
    # (under MXU leaves the test table carries the fragments after its rows)
    assert shade.shape == (n, 12) and tris.shape[0] >= n
    assert np.array_equal(tris[:n], slots[:n, :12])
    assert np.array_equal(shade, slots[:n, 12:])
    assert not slots[n:].any()


def assert_inputs_match(jtabs, ttabs, meta) -> None:
    """The JAX kernel's inputs [cam, obj, nodes, tris, px, py] and the
    port's [cam, obj, nodes, tris, shade, px, py] (numpy or CPU tensors)
    agree: the camera, object table and pixel maps exactly, the mesh tables
    by assert_mesh_tables_match."""
    assert len(jtabs) == 6 and len(ttabs) == 7
    for a, b in zip(jtabs[:2] + jtabs[4:], ttabs[:2] + ttabs[5:]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert_mesh_tables_match(ttabs[2:5], jtabs[2:4], meta)


def jax_fields_np(arrays) -> dict:
    """The JAX SceneArrays as a dict of numpy arrays."""
    return {k: np.asarray(v) for k, v in arrays._asdict().items()}


def fresh_trace_tiles():
    """The JAX trace_tiles under a jit of its own, traced anew on its first
    call: the kernel reads its knobs (PT_SUBPACKET, PT_TRAVERSAL, ...) when
    it is traced, and a new function object keeps this trace out of the
    process-wide jit cache that the other tests share (jax.clear_caches()
    would drop their compiled kernels too)."""
    def trace_tiles(*args, **kw):
        return pk.trace_tiles.__wrapped__(*args, **kw)
    return jax.jit(trace_tiles, static_argnames=(
        "meta", "cfg", "spp", "total_samples", "tile", "spp_pack",
        "pack_axis", "interpret"))


def fresh_grad_tiles():
    """The JAX gradient kernel (pallas_grad.grad_tiles) under a jit of its
    own, as fresh_trace_tiles: its walk reads PT_SUBPACKET and
    PT_ABLATE_LEAF when it is traced."""
    def grad_tiles(*args, **kw):
        return jgrad.grad_tiles.__wrapped__(*args, **kw)
    return jax.jit(grad_tiles, static_argnames=(
        "meta", "cfg", "spp", "total_samples", "tile", "tri_grads",
        "tex_grads", "interpret", "tri_mode"))


def kernel_pair(name: str, tile=None, spp: int = 8, base: int = 0,
                W: int = 32, H: int = 24, fresh_jit: bool = False,
                **cfg_kw):
    """Render scene `name` through the port's trace_tiles (plain version,
    CPU) and the JAX kernel in interpret mode with the same seed vector
    (3, base), total_samples spp + base and layout: the driver's on `tile`
    (None: the scene's default tile), i.e. the scene's default order and
    sample packing. cfg_kw go to both configs (aperture, nee, ...). The
    scenes come from jax_twin (the JAX NumPy path, the port's group
    bounds). fresh_jit traces
    the JAX kernel anew (fresh_trace_tiles), as a knob set in the
    environment needs. Returns (port, JAX) slot sums [3, T*S, L] and the
    port's meta."""
    kw = dict(width=W, height=H, samples=spp, samples_per_pass=spp,
              **cfg_kw)
    js, jc, ja, jm, ts, tc = jax_twin(name, **kw)
    tile = tile or pk.default_tile(jm)
    ttabs, tm, _, layout = port_inputs(ts, tc, tile, torch.device("cpu"))
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    axis = pk.default_pack_axis(jm)
    pack = pk.clamp_pack(pk.default_pack(jm, spp), *tile, axis)
    assert (layout["spp_pack"], layout["pack_axis"]) == (pack, axis)
    xs, ys, _ = pk.tile_pixel_layout(W, H, *tile, order=pk.default_order(jm),
                                     spp_pack=pack, pack_axis=axis)
    jtabs = (pk.build_camera_vec(js.camera), pk.build_scene_table(ja, jm),
             *pk.build_mesh_tables(ja, jm), xs, ys)
    # under MXU leaves the JAX package lane-packs its own triangle table
    # (tests/test_torch_walk_host.py holds the blocks); the classic one
    # holds the port's records
    assert_inputs_match(
        (*jtabs[:2], *pk.build_mesh_tables(ja, jm, traversal="classic"),
         *jtabs[4:]), ttabs, tm)
    seed = (3, base)
    staged = {"tex": ja.tex_staged} if pk.staged_lanes(jm) else {}
    jax_trace_tiles = fresh_trace_tiles() if fresh_jit else pk.trace_tiles
    want = jax_trace_tiles(
        jnp.asarray(seed, jnp.int32), *map(jnp.asarray, jtabs), meta=jm,
        cfg=jc, spp=spp, total_samples=spp + base, tile=tile, spp_pack=pack,
        pack_axis=axis, interpret=True, **staged)
    want = np.stack([np.asarray(v) for v in want])
    before = (mk.trace_tiles.launches, mk.trace_tiles.nee_launches)
    got = torch.stack(mk.trace_tiles(
        seed, *ttabs, meta=tm, cfg=tc, spp=spp, total_samples=spp + base,
        tile=tile, **layout)).numpy()
    # CPU tensors never launch
    assert (mk.trace_tiles.launches, mk.trace_tiles.nee_launches) == before
    return got, want, tm


def mesh_kernel_parity(name: str, aperture: float = 0.0, base: int = 0,
                       W: int = 32, H: int = 24, spp: int = 8):
    """kernel_pair on mesh scene `name` with the driver's mesh tile (8,
    512), held to the per-slot rule. Returns the bit-equal fraction."""
    got, want, tm = kernel_pair(name, (8, 512), spp, base, W, H,
                                aperture=aperture,
                                focal_length=1.6 if aperture else 0.0)
    assert tm.has_groups
    assert_slot_rule(got, want)
    return float((got == want).mean())


def nee_case(name: str, tile=(8, 128), spp: int = 4, base: int = 0,
             **cfg_kw):
    """kernel_pair with cfg.nee on both sides (W x H = 32 x 24), and the
    port's render of the same slots without NEE. Returns (port, JAX, port
    without NEE) slot sums [3, T*S, L]."""
    got, want, _ = kernel_pair(name, tile, spp, base, nee=True, **cfg_kw)
    ts, tc = port_scene(name, width=32, height=24, samples=spp,
                        samples_per_pass=spp, **cfg_kw)
    tabs, meta, _, layout = port_inputs(ts, tc, tile, torch.device("cpu"))
    off = torch.stack(mk.trace_tiles((3, base), *tabs, meta=meta, cfg=tc,
                                     spp=spp, total_samples=spp + base,
                                     tile=tile, **layout)).numpy()
    return got, want, off


def grad_pair(name: str, tile, W: int, H: int, spp: int, seed=(5, 0),
              edit=None, tri_grads: bool = False, tex_grads: bool = False):
    """The gradient kernels of both packages on scene `name` (jax_twin,
    `edit` as there) under the walk knobs set in the environment: the
    port's grad_tiles (its plain version, CPU) and the JAX grad_tiles in
    interpret mode under a fresh jit (fresh_grad_tiles), on the training
    steps' layout on `tile` (default order, no sample packing), with the
    same seed vector and per-slot cotangents made with numpy. With
    tex_grads the port fetches the JAX pool decoded (from_jax_params) and
    the JAX atlas gradient is carried onto the port's texels, zero outside
    the trainable ones. Returns (port results, JAX results as tensors,
    port meta)."""
    js, jc, ja, jm, ts, tc = jax_twin(name, edit=edit, width=W, height=H,
                                      samples=spp, samples_per_pass=spp)
    ta, tm = ts.pack(device="cpu")
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    xs, ys, _ = mk.tile_pixel_layout(W, H, *tile, order=mk.default_order(tm))
    jt = [pk.build_camera_vec(js.camera), pk.build_scene_table(ja, jm),
          *pk.build_mesh_tables(ja, jm), xs, ys]
    tt = [mk.build_camera_vec(ts.camera), mk.build_scene_table(ta, tm),
          *mk.build_mesh_tables(ta, tm), xs, ys]
    assert_inputs_match(jt, tt, tm)
    rng = np.random.default_rng(4)
    cots = [rng.random(xs.shape).astype(np.float32) for _ in range(3)]
    jkw, tkw = {}, {}
    if tex_grads:
        jkw = dict(tex_grads=True, tex=jnp.asarray(ja.tex_staged))
        tkw = dict(tex_grads=True, tex=from_jax_params(
            jax_fields_np(ja), "cpu", meta=tm).tex,
            tex_table=torch.from_numpy(mk.build_tex_table(ta, tm)))
    # the triangle colors vary in training: no uniform-color elision there
    jmeta = dataclasses.replace(jm, tri_uniform_color=None) if tri_grads \
        else jm
    want = fresh_grad_tiles()(
        jnp.asarray(seed, jnp.int32), *map(jnp.asarray, jt),
        *map(jnp.asarray, cots), meta=jmeta, cfg=jc, spp=spp,
        total_samples=spp, tile=tile, tri_grads=tri_grads, interpret=True,
        **jkw)
    want = [torch.from_numpy(np.array(w)) for w in want]
    if tex_grads:
        gtex = tpack.atlas_to_texels(want[2].numpy(), ta, tm)
        gtex[~tpack.trainable_texels(ta, tm)] = 0.0
        want[2] = gtex
    got = tg.grad_tiles(
        seed, *map(torch.from_numpy, tt), *map(torch.from_numpy, cots),
        meta=tm, cfg=tc, spp=spp, total_samples=spp, tile=tile,
        tri_grads=tri_grads, **tkw)
    return got, want, tm
