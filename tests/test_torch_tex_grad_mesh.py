"""pathtracer_tpu_torch's texel gradients on a mesh scene: the `teapot`
stand-in cut to its light, floor, model and sphere, the floor and sphere
textured by small file checkers (tests/_torch_scenes.textured_teapot), the
scene that reaches the mesh instantiation of the texel-gradient kernel
(K6-tex, `<true, true, true, true>`), which no repository scene has.

On the CPU the port's grad_tiles(tex_grads=True) runs its plain version;
it is held against pallas_grad.grad_tiles(tex_grads=True, interpret=True)
with the same seed vector, layout (tile (8, 128), block order, no sample
packing) and per-slot cotangents made with numpy, by the texel rule of
tests/_torch_scenes.py (tex_grad_rule: gcol and gemi within 1e-3 *
max|g|, >= 99% of the texels either side touches within 1e-3 * max|gtex|,
each channel's sum within 1%), the JAX atlas gradient carried onto the
port's texels by scene.pack.atlas_to_texels. The JAX scene is packed on
its NumPy path with the port's group bounds (ROADMAP queue 3). The one
JAX compile of the mesh texel-gradient kernel takes 20-30 s here.

The CUDA kernel is held against the plain version by
tests/test_torch_cuda.py, on a card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import (assert_inputs_match, jax_fields_np, jax_twin,
                           textured_teapot_twin)
from _torch_scenes import tex_grad_rule
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu.render.pallas_grad import grad_tiles as jax_grad_tiles
from pathtracer_tpu_torch.diff import from_jax_params
from pathtracer_tpu_torch.render import grad as tg
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scene import pack

torch.set_num_threads(2)

TILE = (8, 128)


def test_tex_grad_mesh_matches_jax_interpret(record_property):
    W, H, spp = 24, 16, 2
    js, jc, ja, jm, ts, tc = jax_twin(
        "teapot", edit=textured_teapot_twin, width=W, height=H, samples=spp,
        samples_per_pass=spp)
    ta, tm = ts.pack(device="cpu")
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert tm.has_groups and pack.staged_objects(tm)
    xs, ys, _ = mk.tile_pixel_layout(W, H, *TILE, order=mk.default_order(tm))
    jt = [pk.build_camera_vec(js.camera), pk.build_scene_table(ja, jm),
          *pk.build_mesh_tables(ja, jm), xs, ys]
    tt = [mk.build_camera_vec(ts.camera), mk.build_scene_table(ta, tm),
          *mk.build_mesh_tables(ta, tm), xs, ys]
    assert_inputs_match(jt, tt, tm)
    rng = np.random.default_rng(3)
    cots = [rng.random(tt[-2].shape).astype(np.float32) for _ in range(3)]
    seed = (3, 0)
    want = jax_grad_tiles(
        jnp.asarray(seed, jnp.int32), *map(jnp.asarray, jt),
        *map(jnp.asarray, cots), meta=jm, cfg=jc, spp=spp,
        total_samples=spp, tile=TILE, tex_grads=True, interpret=True,
        tex=jnp.asarray(ja.tex_staged))
    want = [np.array(w) for w in want]
    tex = from_jax_params(jax_fields_np(ja), "cpu", meta=tm).tex
    before = (tg.grad_tiles.launches, tg.grad_tiles.tex_launches)
    got = tg.grad_tiles(
        seed, *map(torch.from_numpy, tt), *map(torch.from_numpy, cots),
        meta=tm, cfg=tc, spp=spp, total_samples=spp, tile=TILE,
        tex_grads=True, tex=tex,
        tex_table=torch.from_numpy(mk.build_tex_table(ta, tm)))
    # CPU tensors never launch
    assert (tg.grad_tiles.launches, tg.grad_tiles.tex_launches) == before
    train = pack.trainable_texels(ta, tm)
    gtex = pack.atlas_to_texels(want[2], ta, tm)
    gtex[~train] = 0.0
    err = tex_grad_rule(got, [torch.from_numpy(want[0]),
                              torch.from_numpy(want[1]), gtex])
    for k, v in err.items():
        record_property(k, v)
    assert err["gtex_touched"] >= 100       # the textures are seen
    assert not got[2][~train].any()
