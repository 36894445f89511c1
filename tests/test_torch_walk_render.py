"""pathtracer_tpu_torch's forward megakernel under the JAX package's
sub-packet knobs against the JAX kernel under the same knobs, per slot.

On the CPU the port's trace_tiles runs its plain version, which walks as
the kernel does under the knob (render/megakernel.py mesh_walk: the
warp-packet walk on the thread block's majority octant for PT_SUBPACKET=1
and 2, the warp's for 3); the JAX kernel runs in interpret mode with its
lax.cond gating (=1), its scratch-gated walk (=2, a (8, 512) tile's 4
chunks) or its per-chunk walks (=3), on the driver's mesh layout
(_torch_parity.kernel_pair: tile (8, 512), block order, the sample
replicas on the 128-lane chunks). The walks pick their octant copies over
other groups of rays (a block or a warp here, the tile or a chunk there),
which changes a hit only at exact-t ties. Rule: tests/_torch_scenes.py's
per-slot rule."""
import pytest
import torch

from _torch_parity import kernel_pair
from _torch_scenes import assert_slot_rule
from pathtracer_tpu_torch.render import megakernel as mk

torch.set_num_threads(2)


@pytest.mark.parametrize("env,walk", [
    ({"PT_SUBPACKET": "1"}, "block"),
    ({"PT_SUBPACKET": "2", "PT_TILE_ORDER": "subblock"}, "block"),
])
def test_packet_render_matches_jax_interpret(monkeypatch, env, walk):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert mk.mesh_walk() == mk.Walk(walk, "simt")
    got, want, tm = kernel_pair("teapot", (8, 512), spp=2, W=24, H=16,
                                fresh_jit=True)
    assert tm.has_groups
    assert_slot_rule(got, want)
