"""K1-nee's plain version against the JAX kernel on
`transparency_quad_lights`: four lights, so draw ids 6-13 and four shadow
rays a bounce (rule and method: tests/test_torch_nee.py)."""
import torch

from _torch_parity import nee_case
from _torch_scenes import assert_slot_rule

torch.set_num_threads(2)


def test_nee_matches_jax_interpret_quad_lights(record_property):
    got, want, off = nee_case("transparency_quad_lights")
    record_property("bit_equal_share", float((got == want).mean()))
    assert_slot_rule(got, want)
    assert got.mean() > 1.2 * off.mean()
