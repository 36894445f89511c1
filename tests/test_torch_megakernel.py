"""pathtracer_tpu_torch forward megakernel against the JAX package's.

On the CPU, the port's trace_tiles runs its plain PyTorch version; it is
held per slot against pallas_kernel.trace_tiles(interpret=True) with the
same seed vector, layout and total_samples (both draw the same counter
hash, so they trace the same paths). Rule: >= 99% of slot values within
atol=1e-4, rtol=1e-3, each image-mean channel within 1%.

The CUDA kernel itself is held against the plain version by
tests/test_torch_cuda.py, which needs a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_pack, scene_pair
from _torch_scenes import SLICE_SCENES, assert_slot_rule, port_inputs
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu_torch.render import megakernel as mk

torch.set_num_threads(2)

W, H, TILE, SPP = 32, 24, (8, 128), 4


def _inputs(name, device="cpu", **cfg_kw):
    kw = dict(width=W, height=H, samples=SPP, samples_per_pass=SPP)
    kw.update(cfg_kw)
    js, jc, ts, tc = scene_pair(name, **kw)
    ja, jm = jax_pack(js, ts)
    ttabs, tm, _, _ = port_inputs(ts, tc, TILE, torch.device(device))
    xs, ys, _ = pk.tile_pixel_layout(W, H, *TILE, order="linear")
    jtabs = (pk.build_camera_vec(js.camera), pk.build_scene_table(ja, jm),
             *pk.build_mesh_tables(ja, jm), xs, ys)
    return jtabs, jm, jc, ttabs, tm, tc


CASES = [(name, 0.0, 0) for name in SLICE_SCENES] + [
    ("cylinder", 0.0, 0),
    ("reference", 0.1, 16),   # sunflower DoF at a nonzero sample base
]


@pytest.mark.parametrize("name,aperture,base", CASES)
def test_trace_tiles_matches_jax_interpret(name, aperture, base):
    jtabs, jm, jc, ttabs, tm, tc = _inputs(
        name, aperture=aperture, focal_length=1.6 if aperture else 0.0)
    seed = (3, base)
    total = SPP + base
    want = pk.trace_tiles(
        jnp.asarray(seed, jnp.int32), *map(jnp.asarray, jtabs), meta=jm,
        cfg=jc, spp=SPP, total_samples=total, tile=TILE, interpret=True)
    before = mk.trace_tiles.launches
    got = mk.trace_tiles(seed, *ttabs, meta=tm, cfg=tc, spp=SPP,
                         total_samples=total, tile=TILE)
    assert mk.trace_tiles.launches == before   # CPU tensors never launch
    assert_slot_rule(torch.stack(got).numpy(),
                     np.stack([np.asarray(v) for v in want]))


def test_trace_tiles_matches_jax_interpret_incoherent(monkeypatch):
    # PT_COHERENT=0: per-slot roulette and hemisphere draws instead of the
    # row-shared ones. The JAX kernel reads it when traced, so its jit
    # cache is dropped on both sides of the call.
    jtabs, jm, jc, ttabs, tm, tc = _inputs("transparency_f_light")
    monkeypatch.setenv("PT_COHERENT", "0")
    jax.clear_caches()
    try:
        want = pk.trace_tiles(
            jnp.asarray((3, 0), jnp.int32), *map(jnp.asarray, jtabs),
            meta=jm, cfg=jc, spp=SPP, total_samples=SPP, tile=TILE,
            interpret=True)
        want = np.stack([np.asarray(v) for v in want])
    finally:
        jax.clear_caches()
    got = torch.stack(mk.trace_tiles((3, 0), *ttabs, meta=tm, cfg=tc,
                                     spp=SPP, total_samples=SPP, tile=TILE))
    assert_slot_rule(got.numpy(), want)
    # the draws are really per slot: the coherent render differs
    monkeypatch.setenv("PT_COHERENT", "1")
    coherent = torch.stack(mk.trace_tiles(
        (3, 0), *ttabs, meta=tm, cfg=tc, spp=SPP, total_samples=SPP,
        tile=TILE))
    assert not torch.equal(got, coherent)


def test_trace_tiles_refuses_unported_inputs():
    _, _, _, ttabs, tm, tc = _inputs("reference")
    kw = dict(meta=tm, spp=SPP, total_samples=SPP, tile=TILE)
    with pytest.raises(ValueError, match="spp_pack=3"):   # must divide spp
        mk.trace_tiles((0, 0), *ttabs, cfg=tc, spp_pack=3, **kw)
    with pytest.raises(ValueError, match="pack_axis"):
        mk.trace_tiles((0, 0), *ttabs, cfg=tc, pack_axis="lane", **kw)
    bad = list(ttabs)
    bad[-2] = bad[-2].to(torch.int64)            # px must be int32
    with pytest.raises(ValueError, match="px"):
        mk.trace_tiles((0, 0), *bad, cfg=tc, **kw)
    bad = list(ttabs)
    bad[1] = bad[1][:3]                          # object table rows
    with pytest.raises(ValueError, match="obj_table"):
        mk.trace_tiles((0, 0), *bad, cfg=tc, **kw)


def test_render_megakernel_matches_render_pallas():
    js, jc, ts, tc = scene_pair("reflection", width=W, height=H, samples=SPP,
                                samples_per_pass=SPP, seed=7)
    ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device=torch.device("cpu"))
    want = pk.render_pallas(ja, jm, js.camera, jc, interpret=True, tile=TILE)
    got = mk.render_megakernel(ta, tm, ts.camera, tc, tile=TILE)
    assert got.shape == (H, W, 3) and got.dtype == np.float32
    assert_slot_rule(np.moveaxis(got, -1, 0), np.moveaxis(want, -1, 0))
