"""The intersect-only kernel's plain version against the JAX kernel on the
`teapot` stand-in: the rays walk the BVH on their octant's node copy (rule
and method: tests/test_torch_intersect.py)."""
import torch

from _torch_intersect import intersect_parity

torch.set_num_threads(2)


def test_intersect_matches_jax_interpret_teapot(record_property):
    record_property("winner_equal_share", intersect_parity("teapot"))
