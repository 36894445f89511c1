"""The port's sharded renders against the JAX package's on its virtual CPU
mesh (tests/conftest.py: 8 devices).

parallel.render_sharded_megakernel on a LogicalMesh (one process playing
every rank: each shard's plain megakernel, the spp shards added in rank
order) against render_sharded_pallas(..., interpret=True) at mesh shapes
(2, 2) and (4, 2); parallel.render_sharded (the wavefront) against
render_sharded. Both draw the same streams per shard, keyed by the mesh
coordinates. Rules: the megakernel within 1e-5 at every pixel with at
least 90% of the values bit-equal (not all: the plain version and the
interpret kernel differ in the last bits on about 1% of slots on one
device too, where XLA:CPU fuses multiply-adds; tests/test_torch_megakernel.
py holds them by a per-slot rule), a wrong seed or sample base would move
pixels by tenths; and the render bit-equal to its shards, computed one by
one, added over spp and untiled; the wavefront within 1e-5
(tests/test_torch_wavefront_render.py's rule).
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import jax_pack, scene_pair
from pathtracer_tpu.parallel import make_mesh as jax_mesh
from pathtracer_tpu.parallel.render_dist import render_sharded as jax_sharded
from pathtracer_tpu.parallel.render_dist import render_sharded_pallas
from pathtracer_tpu_torch.parallel import mesh as pmesh
from pathtracer_tpu_torch.parallel import render_dist as rd

torch.set_num_threads(2)

CFG = dict(width=32, height=24, samples=4, samples_per_pass=2)


@pytest.fixture(scope="module")
def pair():
    js, jc, ts, tc = scene_pair("reference", **CFG)
    ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device=torch.device("cpu"))
    return js, jc, ja, jm, ts, tc, ta, tm


def _jax_mesh(shape):
    return jax_mesh(jax.devices()[:shape[0] * shape[1]], shape=shape)


def test_mesh_shapes_and_coordinates():
    assert pmesh.mesh_shape_for(8) == (4, 2)
    assert pmesh.mesh_shape_for(1) == (1, 1)
    assert pmesh.mesh_shape_for(3) == (3, 1)
    assert pmesh.mesh_shape_for(4, spp_parallel=False) == (4, 1)
    assert pmesh.parse_mesh("2x1") == (2, 1)
    for bad in ("2", "0x2", "axb", "2x2x2"):
        with pytest.raises(ValueError):
            pmesh.parse_mesh(bad)
    # rank r at (r // S, r % S), as np.asarray(devices).reshape(shape)
    m = pmesh.LogicalMesh((4, 2))
    assert list(m.coords()) == [tuple(c) for c in np.argwhere(
        np.arange(8).reshape(4, 2) >= 0)]
    assert m.size == 8 and m.shape_tag == "4x2" and m.is_writer
    # a world of one (no process group): only the 1x1 mesh covers it
    one = pmesh.make_mesh()
    assert one.shape == {"pixels": 1, "spp": 1} and one.rank == 0
    assert one.spp_group is None and one.pixels_group is None
    with pytest.raises(ValueError, match="world of 1"):
        pmesh.make_mesh((2, 1))


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_sharded_megakernel_matches_jax(pair, shape):
    js, jc, ja, jm, ts, tc, ta, tm = pair
    got = rd.render_sharded_megakernel(ta, tm, ts.camera, tc,
                                       pmesh.LogicalMesh(shape))
    want = render_sharded_pallas(ja, jm, js.camera, jc, _jax_mesh(shape),
                                 interpret=True)
    assert got.shape == want.shape == (24, 32, 3) and got.dtype == np.float32
    assert np.isfinite(got).all() and got.mean() > 0.01
    assert np.abs(got - want).max() <= 1e-5
    assert (got == want).mean() >= 0.9
    # each shard against the plain megakernel on its own rows and seed, and
    # the sum over spp as the mesh joins it: the LogicalMesh's join
    sh = rd.megakernel_shards(ta, tm, ts.camera, tc, shape)
    assert sh.local_spp == 2 and sh.total_spp == 4
    parts = [[rd.megakernel_shard(sh, p, s) for s in range(shape[1])]
             for p in range(shape[0])]
    flat = torch.cat([a + b for a, b in parts]).numpy()
    img = rd.mk.untile_image(flat, sh.pid, 32, 24).reshape(24, 32, 3) / 4.0
    assert np.array_equal(img, got)
    # the shards are independent streams: no two of a pixel shard agree
    for a, b in parts:
        assert not torch.equal(a, b)


def test_sharded_wavefront_matches_jax(pair):
    js, jc, ja, jm, ts, tc, ta, tm = pair
    shape = (2, 2)
    got = rd.render_sharded(ta, tm, ts.camera, tc, pmesh.LogicalMesh(shape))
    want = np.asarray(jax_sharded(ja, jm, js.camera, jc, _jax_mesh(shape)))
    assert got.shape == want.shape == (24, 32, 3)
    assert np.isfinite(got).all() and got.mean() > 0.01
    assert np.abs(got - want).max() <= 1e-5
    # the interleave puts pixel i on shard i % P
    px, py, perm, pad = rd.interleaved_pixels(32, 24, 2, "cpu")
    assert pad == 0 and np.array_equal(px[:4].numpy(), [0, 2, 4, 6])
    assert np.array_equal(rd.uninterleave(px.numpy()[:, None], perm, 768),
                          (np.arange(768) % 32)[:, None])
