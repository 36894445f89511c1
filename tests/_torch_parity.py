"""Helpers that build the same scene in pathtracer_tpu (JAX) and
pathtracer_tpu_torch and hand both the same inputs."""
from __future__ import annotations

import dataclasses
from unittest import mock

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


def mesh_kernel_parity(name: str, aperture: float = 0.0, base: int = 0,
                       W: int = 32, H: int = 24, spp: int = 8):
    """Render mesh scene `name` through the port's trace_tiles (plain
    version, CPU) and the JAX kernel in interpret mode with the same seed
    vector, layout (the driver's: tile (8, 512), the default order and
    packing) and total_samples; hold them to the per-slot rule. The JAX
    scene is packed on its NumPy path (native scene-core off) and handed
    the port's group bounds: that path packs NaN bounds for a parsed model,
    which would hide it (ROADMAP queue 3). Returns the bit-equal fraction."""
    kw = dict(width=W, height=H, samples=spp, samples_per_pass=spp,
              aperture=aperture, focal_length=1.6 if aperture else 0.0)
    with mock.patch.object(jnative, "available", lambda: False):
        js, jc, ts, tc = scene_pair(name, **kw)
        ja, jm = js.pack()
    tile = (8, 512)
    ttabs, tm, _, layout = port_inputs(ts, tc, tile, torch.device("cpu"))
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert tm.has_groups
    fixed_min = np.asarray(ja.bb_min).copy()
    fixed_max = np.asarray(ja.bb_max).copy()
    for j in tm.group_indices:
        fixed_min[j] = ttabs[1][j, 34:37].numpy()
        fixed_max[j] = ttabs[1][j, 37:40].numpy()
    ja = ja._replace(bb_min=jnp.asarray(fixed_min),
                     bb_max=jnp.asarray(fixed_max))
    axis = pk.default_pack_axis(jm)
    pack = pk.clamp_pack(pk.default_pack(jm, spp), *tile, axis)
    assert layout == {"spp_pack": pack, "pack_axis": axis}
    xs, ys, _ = pk.tile_pixel_layout(W, H, *tile, order=pk.default_order(jm),
                                     spp_pack=pack, pack_axis=axis)
    jtabs = (pk.build_camera_vec(js.camera), pk.build_scene_table(ja, jm),
             *pk.build_mesh_tables(ja, jm), xs, ys)
    for a, b in zip(jtabs, ttabs):
        assert np.array_equal(a, b.numpy())
    seed = (3, base)
    want = pk.trace_tiles(
        jnp.asarray(seed, jnp.int32), *map(jnp.asarray, jtabs), meta=jm,
        cfg=jc, spp=spp, total_samples=spp + base, tile=tile, spp_pack=pack,
        pack_axis=axis, interpret=True)
    want = np.stack([np.asarray(v) for v in want])
    before = mk.trace_tiles.launches
    got = torch.stack(mk.trace_tiles(
        seed, *ttabs, meta=tm, cfg=tc, spp=spp, total_samples=spp + base,
        tile=tile, **layout)).numpy()
    assert mk.trace_tiles.launches == before      # CPU tensors never launch
    assert_slot_rule(got, want)
    return float((got == want).mean())
