"""pathtracer_tpu_torch's gradient kernel under the JAX walk knobs:
PT_SUBPACKET=1 and =2, object and triangle colors on a small `teapot`.

The JAX gradient kernel takes its walk from _packet_traverse
(pallas_grad.py:361-376), which gates its packet walk over the (8, 512)
tile's 128-lane chunks under both modes (pallas_kernel.py:1395-1406). The
port's replay takes the block-packet walk there (render/megakernel.py
grad_walk: the 32 lanes of a warp share a node pointer, on the octant copy
of the thread block's majority). On the CPU the port's grad_tiles runs its
plain version, held against pallas_grad.grad_tiles(tri_grads=True,
interpret=True), traced anew under the knob (fresh_grad_tiles), with the
same seed vector and per-slot numpy cotangents (tests/_torch_parity.py
grad_pair). The two walks take their octant copies by other groups (the
block's majority, the tile's), which changes a hit only on exact-t ties,
so the rule is the gradient rule (tests/_torch_scenes.py grad_rule): gcol
and gemi within 1e-3 of max|g|, >= 99% of the triangle slots within 1e-3
of max|gtri|. Each case is one JAX compile of 20-30 s; the texels under
mode 2 and the leaf ablation are in tests/test_torch_grad_walks_tex.py.
The CUDA instantiations are held against the plain version by
tests/test_torch_cuda.py, on a card.
"""
import pytest
import torch

from _torch_parity import grad_pair
from _torch_scenes import grad_rule
from pathtracer_tpu_torch.render import grad as tg
from pathtracer_tpu_torch.render import megakernel as mk

torch.set_num_threads(2)

TILE = (8, 512)


@pytest.mark.parametrize("mode", ["1", "2"])
def test_grad_under_subpacket_matches_jax_interpret(monkeypatch,
                                                    record_property, mode):
    monkeypatch.setenv("PT_SUBPACKET", mode)
    assert mk.grad_walk() == mk.Walk("block", "simt")
    before = (tg.grad_tiles.launches, tg.grad_tiles.packet_launches)
    got, want, tm = grad_pair("teapot", TILE, 64, 64, 2, tri_grads=True)
    # CPU tensors never launch
    assert (tg.grad_tiles.launches, tg.grad_tiles.packet_launches) == before
    assert tm.has_groups and len(got) == 3
    err = grad_rule(got, want, mesh=True)
    for k, v in err.items():
        record_property(k, v)
    assert err["gtri_slots_hit"] >= 10          # the mesh is on screen
