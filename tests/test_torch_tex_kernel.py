"""pathtracer_tpu_torch's textured megakernel (K1-tex) against the JAX
package's, per slot, on the three scenes whose textures the JAX kernel
computes in-kernel with the same programs that built the port's texel pool
(`textures`: four planar textures, three normal-mapped walls and two
planet spheres; `envmap`: a sky sphere; `cubemap`: a cube-cross sky
around the gopher stand-in).

On the CPU the port's trace_tiles runs its plain PyTorch version, with the
bilinear fetch from the pool; it is held against pallas_kernel.trace_tiles(
interpret=True) with the same seed vector, the driver's layout and
total_samples, by the per-slot rule of the other kernel tests: >= 99% of
slot values within atol=1e-4, rtol=1e-3, each image-mean channel within
1%, where a slot value may also be off by up to 2.5/255, two texel steps
of a directly seen texel. The texels of the pool equal the JAX kernel's
computed ones op by op (tests/test_torch_tex_uv.py), but XLA:CPU contracts
the interpret-mode kernel's multiply-adds into FMAs under jit, which moves
a texel's value before its rgb8 rounding, now and then across a rounding
edge (one texel step; 1.5% of `cubemap`'s slot values), and its sin/cos
and PyTorch's differ by an ulp; on a textured surface such an ulp moves
the UV and with it the blended color. The share of bit-equal slot values
is recorded as the test's `bit_equal_share` property (about 0.5-0.9
here).

The CUDA kernel itself is held against the plain version, bit for bit, by
tests/test_torch_cuda.py, which needs a card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_inputs_match, jax_pack, scene_pair
from _torch_scenes import assert_tex_slot_rule, port_inputs
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu_torch.render import megakernel as mk

torch.set_num_threads(2)

W, H, SPP = 32, 24, 8


def tex_kernel_parity(name, aperture=0.0, base=0):
    """Render `name` through the port's trace_tiles (plain version, CPU)
    and the JAX kernel in interpret mode on the driver's layout. Returns
    (port, JAX) slot sums [3, T*S, L]."""
    kw = dict(width=W, height=H, samples=SPP, samples_per_pass=SPP,
              aperture=aperture, focal_length=1.6 if aperture else 0.0)
    js, jc, ts, tc = scene_pair(name, **kw)
    ja, jm = jax_pack(js, ts)
    tile = pk.default_tile(jm)
    ttabs, tm, _, layout = port_inputs(ts, tc, tile, torch.device("cpu"))
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    axis = pk.default_pack_axis(jm)
    pack = pk.clamp_pack(pk.default_pack(jm, SPP), *tile, axis)
    assert (layout["spp_pack"], layout["pack_axis"]) == (pack, axis)
    xs, ys, _ = pk.tile_pixel_layout(W, H, *tile, order=pk.default_order(jm),
                                     spp_pack=pack, pack_axis=axis)
    jtabs = (pk.build_camera_vec(js.camera), pk.build_scene_table(ja, jm),
             *pk.build_mesh_tables(ja, jm), xs, ys)
    assert_inputs_match(jtabs, ttabs, tm)
    seed = (3, base)
    staged = {"tex": ja.tex_staged} if pk.staged_lanes(jm) else {}
    want = pk.trace_tiles(
        jnp.asarray(seed, jnp.int32), *map(jnp.asarray, jtabs), meta=jm,
        cfg=jc, spp=SPP, total_samples=SPP + base, tile=tile, spp_pack=pack,
        pack_axis=axis, interpret=True, **staged)
    before = (mk.trace_tiles.launches, mk.trace_tiles.tex_launches)
    got = mk.trace_tiles(seed, *ttabs, meta=tm, cfg=tc, spp=SPP,
                         total_samples=SPP + base, tile=tile, **layout)
    # CPU tensors never launch
    assert (mk.trace_tiles.launches, mk.trace_tiles.tex_launches) == before
    return (torch.stack(got).numpy(),
            np.stack([np.asarray(v) for v in want]))


@pytest.mark.parametrize("name,aperture,base", [
    ("textures", 0.0, 0),
    ("envmap", 0.0, 0),
    ("cubemap", 0.0, 0),
    ("textures", 0.1, 16),       # sunflower DoF at a nonzero sample base
])
def test_tex_kernel_matches_jax_interpret(record_property, name, aperture,
                                          base):
    got, want = tex_kernel_parity(name, aperture, base)
    share = float((got == want).mean())
    record_property("bit_equal_share", share)
    assert_tex_slot_rule(got, want)
    # the textured paths are the same paths: most values agree to the bit
    assert share > 0.25, share
