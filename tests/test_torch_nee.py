"""pathtracer_tpu_torch's next-event estimation (cfg.nee, K1-nee) against
the JAX package's megakernel NEE block (pallas_kernel.py:2421-2513).

On the CPU the port's trace_tiles runs its plain PyTorch version; with the
same seed vector, layout and total_samples it draws the same light points
from the same counter hash (draw ids 6 + 2 li and 7 + 2 li, coherent like
the roulette's) as pallas_kernel.trace_tiles(nee=True, interpret=True), so
the two trace the same paths and shadow rays. Rule: the per-slot rule of
tests/_torch_scenes.py, >= 99% of slot values within atol=1e-4, rtol=1e-3,
each image-mean channel within 1% (the textured scene also allows two
texel steps, as tests/test_torch_tex_kernel.py does). XLA:CPU contracts
the interpret kernel's multiply-adds into FMAs, so the two agree to the bit
on only part of the slots.

One JAX compile of the NEE kernel takes 7-20 s here, so the cases are
spread over tests/test_torch_nee*.py: `reference` (1 light) here;
`transparency_quad_lights` (4), `transparency_f_light` (3), the `teapot`
stand-in on the driver's chunk packing (the mesh shadow walk), `textures`
(textured, 2 lights), depth of field and PT_COHERENT=0 in the others.

The CUDA kernel is held against the plain version, bit for bit, by
tests/test_torch_cuda.py, which needs a card.
"""
import numpy as np
import pytest
import torch

from _torch_parity import nee_case, scene_pair
from _torch_scenes import assert_slot_rule, port_inputs
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scene import pack

torch.set_num_threads(2)

TILE = (8, 128)


def test_nee_matches_jax_interpret_reference(record_property):
    got, want, off = nee_case("reference")
    record_property("bit_equal_share", float((got == want).mean()))
    assert_slot_rule(got, want)
    # NEE fired: the shadow rays add light on top of the path estimator
    assert got.mean() > 1.2 * off.mean()


def _cpu_inputs(name, **cfg_kw):
    _, _, ts, tc = scene_pair(name, width=16, height=12, samples=2,
                              samples_per_pass=2, **cfg_kw)
    tabs, meta, _, layout = port_inputs(ts, tc, TILE, torch.device("cpu"))
    kw = dict(meta=meta, cfg=tc, spp=2, total_samples=2, tile=TILE,
              **layout)
    return tabs, kw, ts


def test_nee_counts_shadow_work():
    tabs, kw, _ = _cpu_inputs("transparency_quad_lights", nee=True)
    counts = {}
    mk.trace_tiles_reference((1, 0), *tabs, **kw, counts=counts)
    assert len(kw["meta"].light_indices) == 4
    # one light point per light at each hit that neither refracts nor is a
    # light; only those facing the surface cast their ray
    assert counts["shadow_rays"] % 4 == 0
    assert 0 < counts["shadow_tests"] < counts["shadow_rays"]
    assert counts["shadow_rays"] <= 4 * counts["hits"]
    off = {}
    mk.trace_tiles_reference((1, 0), *tabs, **dict(kw, cfg=kw["cfg"].replace(
        nee=False)), counts=off)
    assert off["shadow_rays"] == off["shadow_tests"] == 0
    assert off["hits"] == counts["hits"]    # the same paths


def test_nee_without_a_light_renders_as_without_nee():
    # a scene whose only emitter is dark packs no light: cfg.nee changes
    # nothing, as in the JAX kernel (pallas_kernel.py:2430)
    tabs, kw, ts = _cpu_inputs("reference", nee=True)
    ts.objects[0].material.emission = (0.0, 0.0, 0.0)
    arrays, meta = ts.pack(device="cpu")
    assert meta.light_indices == () and mk.nee_lights(meta, kw["cfg"]) == ()
    tabs[1] = torch.from_numpy(mk.build_scene_table(arrays, meta))
    kw["meta"] = meta
    on = mk.trace_tiles((1, 0), *tabs, **kw)
    off = mk.trace_tiles((1, 0), *tabs, **dict(kw, cfg=kw["cfg"].replace(
        nee=False)))
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_nee_refuses_f32_texels():
    # the f32-texel forward serves the differentiable render, which does
    # not replay shadow draws
    tabs, kw, ts = _cpu_inputs("textures-train", nee=True)
    arrays, _ = ts.pack(device="cpu")
    kw.pop("tex_pool")
    with pytest.raises(NotImplementedError, match="f32 texels"):
        mk.trace_tiles((1, 0), *tabs, **kw,
                       tex_texels=pack.texel_params(arrays))
    # without NEE the same call renders
    out = mk.trace_tiles((1, 0), *tabs, **dict(kw, cfg=kw["cfg"].replace(
        nee=False)), tex_texels=pack.texel_params(arrays))
    assert np.isfinite(torch.stack(out).numpy()).all()
