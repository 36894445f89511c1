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
from _torch_scenes import assert_slot_rule, cylinder_scene, port_inputs
from pathtracer_tpu import config as jconfig
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu.geometry import transforms as jgx
from pathtracer_tpu.scene import material as jmat
from pathtracer_tpu.scene import pack as jpack
from pathtracer_tpu.scene import shapes as jshapes
from pathtracer_tpu.scenes import cornell as jcornell
from pathtracer_tpu_torch import config as tconfig
from pathtracer_tpu_torch.geometry import transforms as tgx
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scene import material as tmat
from pathtracer_tpu_torch.scene import pack as tpack
from pathtracer_tpu_torch.scene import shapes as tshapes
from pathtracer_tpu_torch.scenes import cornell as tcornell


def scene_pair(name: str, **cfg_kw):
    """(JAX scene, JAX cfg, torch scene, torch cfg) for a slice scene or
    the synthetic "cylinder" scene (closed cylinder + glass cube)."""
    jc = jconfig.RenderConfig(**cfg_kw)
    tc = tconfig.RenderConfig(**cfg_kw)
    if name == "cylinder":
        return (cylinder_scene(jc, jgx, jmat, jshapes, jpack, jcornell), jc,
                cylinder_scene(tc, tgx, tmat, tshapes, tpack, tcornell), tc)
    return (jscenes.get_scene(name, jc), jc, tscenes.get_scene(name, tc), tc)


def jax_pack(js, ts, **kw):
    """The JAX package's pack of scene js at the BVH leaf size the port
    packs its twin ts at (scene.pack.leaf_size_for: PT_BVH_LEAF, else the
    port's rule), on its NumPy path (native scene-core off: the port
    builds its BVH as that path does), so both walk the same slots."""
    with mock.patch.object(jnative, "available", lambda: False):
        return js.pack(leaf_size=tpack.leaf_size_for(ts.objects), **kw)


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


def kernel_pair(name: str, tile=None, spp: int = 8, base: int = 0,
                W: int = 32, H: int = 24, fresh_jit: bool = False,
                **cfg_kw):
    """Render scene `name` through the port's trace_tiles (plain version,
    CPU) and the JAX kernel in interpret mode with the same seed vector
    (3, base), total_samples spp + base and layout: the driver's on `tile`
    (None: the scene's default tile), i.e. the scene's default order and
    sample packing. cfg_kw go to both configs (aperture, nee, ...). A mesh
    scene is packed on the JAX NumPy path (native scene-core off) and
    handed the port's group bounds: that path packs NaN bounds for a
    parsed model, which would hide it (ROADMAP queue 3). fresh_jit traces
    the JAX kernel anew (fresh_trace_tiles), as a knob set in the
    environment needs. Returns (port, JAX) slot sums [3, T*S, L] and the
    port's meta."""
    kw = dict(width=W, height=H, samples=spp, samples_per_pass=spp,
              **cfg_kw)
    with mock.patch.object(jnative, "available", lambda: False):
        js, jc, ts, tc = scene_pair(name, **kw)
        ja, jm = jax_pack(js, ts)
    tile = tile or pk.default_tile(jm)
    ttabs, tm, _, layout = port_inputs(ts, tc, tile, torch.device("cpu"))
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    fixed_min = np.asarray(ja.bb_min).copy()
    fixed_max = np.asarray(ja.bb_max).copy()
    for j in tm.group_indices:
        fixed_min[j] = ttabs[1][j, 34:37].numpy()
        fixed_max[j] = ttabs[1][j, 37:40].numpy()
    ja = ja._replace(bb_min=jnp.asarray(fixed_min),
                     bb_max=jnp.asarray(fixed_max))
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
    _, _, ts, tc = scene_pair(name, width=32, height=24, samples=spp,
                              samples_per_pass=spp, **cfg_kw)
    tabs, meta, _, layout = port_inputs(ts, tc, tile, torch.device("cpu"))
    off = torch.stack(mk.trace_tiles((3, base), *tabs, meta=meta, cfg=tc,
                                     spp=spp, total_samples=spp + base,
                                     tile=tile, **layout)).numpy()
    return got, want, off
