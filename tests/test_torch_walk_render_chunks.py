"""pathtracer_tpu_torch's forward megakernel under PT_SUBPACKET=3 (the
warp-packet walk on each warp's majority octant; the JAX kernel's
independent 128-lane chunk walks) and under PT_ABLATE_LEAF=1 (the node walk
alone: no triangle is hit, on either side) against the JAX kernel in
interpret mode under the same knobs, per slot (method and rule:
tests/test_torch_walk_render.py)."""
import pytest
import torch

from _torch_parity import kernel_pair
from _torch_scenes import assert_slot_rule
from pathtracer_tpu_torch.render import megakernel as mk

torch.set_num_threads(2)


@pytest.mark.parametrize("env,walk", [
    ({"PT_SUBPACKET": "3"}, ("warp", "simt")),
    ({"PT_ABLATE_LEAF": "1", "PT_TILE_ORDER": "rowblock"},
     ("thread", "none")),
])
def test_chunk_walks_match_jax_interpret(monkeypatch, env, walk):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert mk.mesh_walk() == mk.Walk(*walk)
    got, want, tm = kernel_pair("teapot", (8, 512), spp=2, W=24, H=16,
                                fresh_jit=True)
    assert_slot_rule(got, want)
