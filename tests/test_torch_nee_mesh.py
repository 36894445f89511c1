"""K1-nee's plain version against the JAX kernel on the `teapot` stand-in
with the driver's mesh layout (tile (8, 512), block order, 4 sample
replicas on the 128-lane chunks, whose coherent draws the shadow rays'
light points share): the shadow rays walk the BVH (rule and method:
tests/test_torch_nee.py)."""
import torch

from _torch_parity import nee_case
from _torch_scenes import assert_slot_rule

torch.set_num_threads(2)


def test_nee_matches_jax_interpret_teapot(record_property):
    got, want, off = nee_case("teapot", tile=(8, 512), spp=8)
    record_property("bit_equal_share", float((got == want).mean()))
    assert_slot_rule(got, want)
    assert got.mean() > 1.2 * off.mean()
