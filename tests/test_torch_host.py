"""pathtracer_tpu_torch host layer against pathtracer_tpu: packed scene
fields, kernel tables, camera vector and tile layout must be exactly equal
(both build in float64 numpy and cast to float32 the same way)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_mesh_tables_match, jax_fields_np, jax_pack,
                           scene_pair)
from _torch_scenes import MESH_SCENES, SLICE_SCENES, TEX_SCENES
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu.scenes import get_scene as jax_get_scene
from pathtracer_tpu.scenes import list_scenes as jax_list_scenes
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scene import Sphere, from_jax_scene, pack_scene
from pathtracer_tpu_torch.scenes import list_scenes

torch.set_num_threads(2)

ALL = SLICE_SCENES + ("cylinder",)


@pytest.mark.parametrize("name", ALL)
def test_pack_and_tables_equal_jax(name):
    js, _, ts, _ = scene_pair(name, width=48, height=36, samples=4)
    ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device=torch.device("cpu"))
    for field, want in jax_fields_np(ja).items():
        got = getattr(ta, field).numpy()
        assert got.dtype == want.dtype, field
        assert np.array_equal(got, want), field
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert np.array_equal(mk.build_scene_table(ta, tm),
                          pk.build_scene_table(ja, jm))
    assert_mesh_tables_match(mk.build_mesh_tables(ta, tm),
                             pk.build_mesh_tables(ja, jm), tm)
    assert np.array_equal(mk.build_camera_vec(ts.camera),
                          pk.build_camera_vec(js.camera))
    # defaults that pick the tile, order and packing
    assert mk.default_tile(tm) == pk.default_tile(jm)
    assert mk.default_order(tm) == pk.default_order(jm)
    assert mk.default_pack_axis(tm) == pk.default_pack_axis(jm)
    assert mk.default_pack(tm, 8) == pk.default_pack(jm, 8)


@pytest.mark.parametrize("env", [
    {}, {"PT_SPP_PACK": "4"}, {"PT_SPP_PACK": "3"},
    {"PT_PACK_AXIS": "chunk"}, {"PT_SPP_PACK": "8", "PT_PACK_AXIS": "chunk"},
    {"PT_TILE_ORDER": "block"},
])
def test_layout_knobs_equal_jax(monkeypatch, env):
    # the environment overrides pick the same tile order, pack axis and
    # packing factor as in the JAX package (the driver's layout tag)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _, _, ts, _ = scene_pair("reference", width=16, height=12)
    _, tm = ts.pack(device=torch.device("cpu"))
    assert mk.default_order(tm) == pk.default_order(tm)
    assert mk.default_pack_axis(tm) == pk.default_pack_axis(tm)
    for spp in (None, 1, 6, 8, 128):
        assert mk.default_pack(tm, spp) == pk.default_pack(tm, spp)
    for pack in (1, 2, 3, 8, 16):
        for S, L in ((64, 256), (8, 512), (8, 128)):
            for axis in ("row", "chunk"):
                assert mk.clamp_pack(pack, S, L, axis) == \
                    pk.clamp_pack(pack, S, L, axis)


@pytest.mark.parametrize("name", ("reference", "transparency_f_light"))
def test_from_jax_scene_round_trip(name):
    js, _, ts, _ = scene_pair(name, width=32, height=24, samples=1)
    ja, jm = jax_pack(js, ts)
    fa, fm = from_jax_scene(jax_fields_np(ja), jm, torch.device("cpu"))
    ta, tm = ts.pack(device=torch.device("cpu"))
    assert fm == tm
    for field in ta._fields:
        assert torch.equal(getattr(fa, field), getattr(ta, field)), field


@pytest.mark.parametrize("order", ("linear", "block", "subblock", "rowblock"))
@pytest.mark.parametrize("W,H,S,L,granule", [
    (32, 24, 8, 128, 1),      # one tile, padded
    (100, 37, 8, 128, 2),     # ragged width, padded rows for sharding
    (160, 120, 64, 256, 1),   # the primitive-scene tile
])
def test_tile_layout_and_untile_equal_jax(order, W, H, S, L, granule):
    got = mk.tile_pixel_layout(W, H, S, L, shard_granule=granule,
                               order=order)
    want = pk.tile_pixel_layout(W, H, S, L, shard_granule=granule,
                                order=order)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    pid = got[2]
    assert (pid == -1).any() or pid.size == W * H
    flat = np.random.default_rng(0).random((pid.size, 3)).astype(np.float32)
    assert np.array_equal(mk.untile_image(flat, pid, W, H),
                          pk.untile_image(flat, pid, W, H))


def test_registry_holds_the_slice_scenes():
    # every scene of the JAX package, textured ones included
    assert list_scenes() == jax_list_scenes()
    assert list_scenes() == sorted(SLICE_SCENES + MESH_SCENES + TEX_SCENES)


def test_unported_scene_parts_raise(monkeypatch):
    cpu = torch.device("cpu")
    # the JAX wavefront path's quad-row texel pool
    monkeypatch.setenv("PT_TEX_FETCH", "quad")
    with pytest.raises(NotImplementedError, match="item 12"):
        pack_scene([Sphere()], device=cpu,
                   sphere_textures=[np.zeros((2, 2, 3))])
    monkeypatch.delenv("PT_TEX_FETCH")
    # a textured scene carried over from the JAX package keeps its textures
    cfg = RenderConfig(width=16, height=12)
    ja, jm = jax_get_scene("textures", cfg).pack(dtype=jnp.float32)
    ta, tm = from_jax_scene(jax_fields_np(ja), jm, cpu)
    assert tm.obj_tex == jm.obj_tex and ta.tex_pool_u32.numel() > 1
    # the tile orders of the TPU's sub-packet gating and MXU leaf machine
    # are ported: the JAX package's slots, row-packed too
    for order in ("subblock", "rowblock"):
        got = mk.tile_pixel_layout(16, 12, 8, 128, order=order, spp_pack=2)
        want = pk.tile_pixel_layout(16, 12, 8, 128, order=order, spp_pack=2)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="tile order"):
        mk.tile_pixel_layout(16, 12, 8, 128, order="spiral")
