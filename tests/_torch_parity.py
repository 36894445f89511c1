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
        ja, jm = js.pack()
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
    for i, (a, b) in enumerate(zip(jtabs, ttabs)):
        # under MXU leaves the JAX package lane-packs its own table
        # (tests/test_torch_walk_host.py holds the blocks)
        if not (i == 3 and jm.has_groups
                and pk.traversal_mode(jm) == "mxu"):
            assert np.array_equal(a, b.numpy())
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
