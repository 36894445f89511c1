"""pathtracer_tpu_torch's gradient kernel under the JAX walk knobs, the
second file (tests/test_torch_grad_walks.py has modes 1 and 2 in triangle
mode): texel gradients on the textured `teapot`
(tests/_torch_scenes.textured_teapot) under PT_SUBPACKET=2, and the leaf
ablation PT_ABLATE_LEAF=1 in triangle mode.

On the CPU the port's grad_tiles runs its plain version, held against
pallas_grad.grad_tiles(interpret=True) traced anew under the knob, the
same seed vector and per-slot numpy cotangents (tests/_torch_parity.py
grad_pair), on the (8, 512) tile. Rules: the texel rule (tex_grad_rule:
gcol and gemi within 1e-3 of max|g|, >= 99% of the texels either side
touches within 1e-3 of max|gtex|, each channel's sum within 1%); under the
ablation no triangle is ever hit (the node walk alone, pallas_kernel.py
:1487-1493; the port's "none" leaves), so the triangle gradient is exactly
zero on both sides, and the object gradients, of the rays that pass
through the mesh, follow the gradient rule. One JAX compile a case
(20-30 s).
"""
import torch

from _torch_parity import grad_pair, textured_teapot_twin
from _torch_scenes import ablated_grad_rule, tex_grad_rule
from pathtracer_tpu_torch.render import megakernel as mk

torch.set_num_threads(2)

TILE = (8, 512)


def test_tex_grad_under_subpacket_2_matches_jax_interpret(monkeypatch,
                                                          record_property):
    monkeypatch.setenv("PT_SUBPACKET", "2")
    got, want, tm = grad_pair("teapot", TILE, 64, 64, 2,
                              edit=textured_teapot_twin, tex_grads=True)
    assert tm.has_groups and len(got) == 3
    err = tex_grad_rule(got, want)
    for k, v in err.items():
        record_property(k, v)
    assert err["gtex_touched"] >= 100       # the textures are seen


def test_ablated_leaves_give_zero_triangle_grads(monkeypatch,
                                                 record_property):
    monkeypatch.setenv("PT_ABLATE_LEAF", "1")
    assert mk.grad_walk() == mk.Walk("thread", "none")
    got, want, _ = grad_pair("teapot", TILE, 64, 64, 2, tri_grads=True)
    err = ablated_grad_rule(got, want)
    for k, v in err.items():
        record_property(k, v)
    assert got[0].abs().max() > 0           # the walls still take gradients
