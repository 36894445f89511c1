"""K1-nee's plain version against the JAX kernel on `textures`: two lights
and textured walls and planets, so the shadow rays' contribution takes the
texel's color (rule and method: tests/test_torch_nee.py, with the
textured allowance of two texel steps)."""
import torch

from _torch_parity import nee_case
from _torch_scenes import assert_tex_slot_rule

torch.set_num_threads(2)


def test_nee_matches_jax_interpret_textures(record_property):
    got, want, off = nee_case("textures")
    record_property("bit_equal_share", float((got == want).mean()))
    assert_tex_slot_rule(got, want)
    assert got.mean() > 1.2 * off.mean()
