"""K1-nee's plain version against the JAX kernel on `reference` under
depth of field (the sunflower at a nonzero sample base) and under
PT_COHERENT=0, whose light points are drawn per slot instead of per tile
row (rule and method: tests/test_torch_nee.py)."""
import jax
import torch

from _torch_parity import nee_case
from _torch_scenes import assert_slot_rule

torch.set_num_threads(2)


def test_nee_matches_jax_interpret_dof(record_property):
    got, want, off = nee_case("reference", aperture=0.1, focal_length=1.6,
                              base=16)
    record_property("bit_equal_share", float((got == want).mean()))
    assert_slot_rule(got, want)
    assert got.mean() > 1.2 * off.mean()


def test_nee_matches_jax_interpret_incoherent(monkeypatch, record_property):
    # the JAX kernel reads PT_COHERENT when traced: its jit cache is
    # dropped on both sides of the call
    monkeypatch.setenv("PT_COHERENT", "0")
    jax.clear_caches()
    try:
        got, want, off = nee_case("reference")
    finally:
        jax.clear_caches()
    record_property("bit_equal_share", float((got == want).mean()))
    assert_slot_rule(got, want)
    assert got.mean() > 1.2 * off.mean()
