"""pathtracer_tpu_torch's textured megakernel on the file-texture scenes,
held by bounds. The JAX package fetches these plain-array images from a
staged atlas (one-hot matmuls, a texture blended y before x, and
`envmap-file`'s 2048x1024 sky as a 128x128 mip); the port fetches every
texture from the full-resolution pool with the x-first blend. So the
fetched colors differ by ulps (and `envmap-file`'s by design), and on
`textures-file` the normal maps turn those ulps into other ray directions:
the images are held as whole images, not per slot.

- `textures-train` (no normal maps) against render_pallas in interpret
  mode: the JAX package's own staged-vs-procedural bounds
  (tests/test_pallas.py:704-705): max |diff| < 2e-2, mean |diff| < 1e-3.
- `textures-file` (normal-mapped walls) against render_pallas, and
  `envmap-file` against the JAX wavefront `render`, which samples the
  full-resolution pool: the bounds of tests/test_proctex.py:182-184 for
  two estimators of one image, |mean diff| < 0.04 (there: < bound) and
  mean |diff| < 0.2.
"""
import numpy as np
import pytest
import torch

from _torch_parity import jax_pack, scene_pair
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu.render.integrator import render
from pathtracer_tpu_torch.render import megakernel as mk

torch.set_num_threads(2)


@pytest.mark.parametrize("name,spp,ref", [
    ("textures-train", 8, "pallas"),
    ("textures-file", 8, "pallas"),
    ("envmap-file", 16, "wavefront"),
])
def test_file_texture_scene_within_bounds(record_property, name, spp, ref):
    js, jc, ts, tc = scene_pair(name, width=32, height=24, samples=spp,
                                samples_per_pass=spp)
    ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device=torch.device("cpu"))
    assert pk.staged_lanes(jm) and mk.default_tile(tm) == (8, 512)
    got = mk.render_megakernel(ta, tm, ts.camera, tc)
    if ref == "pallas":
        want = pk.render_pallas(ja, jm, js.camera, jc, interpret=True,
                                tile=pk.default_tile(jm))
    else:
        want = np.asarray(render(ja, jm, js.camera, jc))
    assert got.shape == want.shape == (24, 32, 3)
    assert np.isfinite(got).all() and got.min() >= 0.0
    d = np.abs(got - want)
    record_property("max_abs_diff", float(d.max()))
    record_property("mean_abs_diff", float(d.mean()))
    if name == "textures-train":
        assert d.max() < 2e-2 and d.mean() < 1e-3, (d.max(), d.mean())
    else:
        assert abs(got.mean() - want.mean()) < 0.04
        assert d.mean() < 0.2
