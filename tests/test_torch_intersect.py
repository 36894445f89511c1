"""pathtracer_tpu_torch's intersect-only kernel (K5, intersect_batch)
against the JAX package's (pallas_kernel._make_intersect_kernel).

intersect_tiles has no interpret switch, so the JAX kernel is wrapped here
in its own interpret-mode pallas_call with intersect_tiles' specs
(pallas_kernel.py:2829-2842), on JAX tables from scene_tables_jnp(...,
traversal="classic") and rays padded to whole (8, 128) tiles as
intersect_batch pads them. On the CPU the port's intersect_batch runs its
plain version (intersect_batch_reference). Rays: jittered camera rays and
rays that start outside the scene and leave it (mostly misses), then one
bounce of random rays from their hit points (uniform directions on the
incoming side, tests/_torch_scenes.bounce_rays), on `reference`, the
`teapot` stand-in (tests/test_torch_intersect_mesh.py) and the cylinder/box
scene.

Rule, per ray: the winner and the triangle flag equal except at t-ties
(two objects whose t lie within TIE_REL of each other, where one ulp of
the JAX kernel's FMA-contracted transforms can pick the other); where the
winners agree, t and the object-space ray within atol=1e-5, rtol=1e-4 (the
same f32 operations, with XLA:CPU's FMAs on the JAX side), and where a
triangle won, its smooth normal and color within the same tolerance. The
JAX kernel keeps the last triangle's normal and color when a primitive
later in the table wins; the port writes zeros there, which is also held.

The CUDA kernel is held against the plain version, bit for bit, by
tests/test_torch_cuda.py, which needs a card.
"""
import pytest
import torch

from _torch_intersect import intersect_parity
from _torch_parity import scene_pair
from pathtracer_tpu_torch.render import megakernel as mk

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["reference", "cylinder"])
def test_intersect_matches_jax_interpret(record_property, name):
    record_property("winner_equal_share", intersect_parity(name))


def test_intersect_batch_refuses_bad_rays():
    _, _, ts, tc = scene_pair("reference", width=8, height=6)
    ta, tm = ts.pack(device="cpu")
    o = [torch.zeros(4) for _ in range(3)]
    d = [torch.ones(4) for _ in range(3)]
    with pytest.raises(ValueError, match="3-tuples"):
        mk.intersect_batch(ta, tm, tc, o[:2], d)
    with pytest.raises(ValueError, match="contiguous f32"):
        mk.intersect_batch(ta, tm, tc, o, d[:2] + [torch.ones(5)])
    with pytest.raises(ValueError, match="contiguous f32"):
        mk.intersect_batch(ta, tm, tc, o, [x.double() for x in d])
