"""Training a mip-staged texture: `envmap-file` with its 2048x1024 sky
replaced by the mip the JAX package stages for it (box-filtered down to
PT_TEX_MIP_AREA, here by the test's own 2x2 box filter, as the JAX pack's
_mip2 makes it). An image that small the JAX package stages as it is, with
no mip, so both packages render and train the same 128x64 texels.

On the CPU the port runs its plain versions: the forward (trace_tiles,
whose fetch takes the kernel's wrap, sample_pool) is held per slot against
pallas_kernel.trace_tiles(interpret=True) by the allowance of
tests/test_torch_tex_kernel.py, and the texel gradients (grad_tiles(
tex_grads=True), whose taps are the kernel's texel_taps) against
pallas_grad.grad_tiles(tex_grads=True, interpret=True) by the rule of
tests/test_torch_tex_grad.py, in the JAX atlas's layout."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import (assert_inputs_match, jax_fields_np, jax_pack,
                           scene_pair)
from _torch_scenes import (GRAD_REL_MESH, SLOT_FRAC, assert_tex_slot_rule,
                           port_inputs)
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu.render.pallas_grad import grad_tiles as jax_grad_tiles
from pathtracer_tpu_torch.diff import from_jax_params
from pathtracer_tpu_torch.render import grad as tg
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scene import pack

torch.set_num_threads(2)

MIP_AREA = 128 * 128     # the JAX package's PT_TEX_MIP_AREA default
GRAD_TILE = (8, 128)
SUM_REL = 0.01


def _mip2(im: np.ndarray) -> np.ndarray:
    """One box-filtered mip level: 2x2 average, an odd tail row or column
    edge-replicated first."""
    if im.shape[0] % 2:
        im = np.concatenate([im, im[-1:]], axis=0)
    if im.shape[1] % 2:
        im = np.concatenate([im, im[:, -1:]], axis=1)
    h2, w2 = im.shape[0] // 2, im.shape[1] // 2
    return im.reshape(h2, 2, w2, 2, *im.shape[2:]).mean(axis=(1, 3))


def mip_pair(W, H, spp):
    """Both packages' `envmap-file` with its sky the staged mip, packed,
    with their tables and metadata checked equal. Returns (JAX scene,
    cfg, arrays, meta, port scene, cfg, arrays, meta)."""
    kw = dict(width=W, height=H, samples=spp, samples_per_pass=spp)
    js, jc, ts, tc = scene_pair("envmap-file", **kw)
    mip = np.asarray(ts.sphere_textures[0], np.float64)
    while mip.shape[0] * mip.shape[1] > MIP_AREA:
        mip = _mip2(mip)
    mip = mip.astype(np.float32)
    assert mip.shape[:2] == (64, 128)
    js.sphere_textures, ts.sphere_textures = [mip.copy()], [mip.copy()]
    ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device="cpu")
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    # staged as it is: its texels train in both packages
    assert pk.staged_lanes(jm) and tm.obj_tex[0][1] == ("__staged__", 0,
                                                        128, 64)
    assert pack.staged_objects(tm) == (tm.obj_tex[0][0],)
    return js, jc, ja, jm, ts, tc, ta, tm


def test_mip_staged_forward_matches_jax_interpret(record_property):
    W, H, spp = 32, 24, 8
    js, jc, ja, jm, ts, tc, ta, tm = mip_pair(W, H, spp)
    tile = pk.default_tile(jm)
    ttabs, _, _, layout = port_inputs(ts, tc, tile, torch.device("cpu"))
    axis = pk.default_pack_axis(jm)
    packing = pk.clamp_pack(pk.default_pack(jm, spp), *tile, axis)
    assert (layout["spp_pack"], layout["pack_axis"]) == (packing, axis)
    xs, ys, _ = pk.tile_pixel_layout(W, H, *tile, order=pk.default_order(jm),
                                     spp_pack=packing, pack_axis=axis)
    jtabs = (pk.build_camera_vec(js.camera), pk.build_scene_table(ja, jm),
             *pk.build_mesh_tables(ja, jm), xs, ys)
    assert_inputs_match(jtabs, ttabs, tm)
    seed = (3, 0)
    want = pk.trace_tiles(
        jnp.asarray(seed, jnp.int32), *map(jnp.asarray, jtabs), meta=jm,
        cfg=jc, spp=spp, total_samples=spp, tile=tile, spp_pack=packing,
        pack_axis=axis, interpret=True, tex=ja.tex_staged)
    got = torch.stack(mk.trace_tiles(seed, *ttabs, meta=tm, cfg=tc, spp=spp,
                                     total_samples=spp, tile=tile,
                                     **layout)).numpy()
    want = np.stack([np.asarray(v) for v in want])
    record_property("bit_equal_share", float((got == want).mean()))
    assert_tex_slot_rule(got, want)


def test_mip_staged_texel_grads_match_jax_interpret(record_property):
    W, H, spp, seed = 24, 16, 2, (3, 0)
    js, jc, ja, jm, ts, tc, ta, tm = mip_pair(W, H, spp)
    xs, ys, _ = mk.tile_pixel_layout(W, H, *GRAD_TILE,
                                     order=mk.default_order(tm))
    jt = [pk.build_camera_vec(js.camera), pk.build_scene_table(ja, jm),
          *pk.build_mesh_tables(ja, jm), xs, ys]
    tt = [mk.build_camera_vec(ts.camera), mk.build_scene_table(ta, tm),
          *mk.build_mesh_tables(ta, tm), xs, ys]
    assert_inputs_match(jt, tt, tm)
    rng = np.random.default_rng(5)
    cots = [rng.random(xs.shape).astype(np.float32) for _ in range(3)]
    want = jax_grad_tiles(
        jnp.asarray(seed, jnp.int32), *map(jnp.asarray, jt),
        *map(jnp.asarray, cots), meta=jm, cfg=jc, spp=spp,
        total_samples=spp, tile=GRAD_TILE, tex_grads=True, interpret=True,
        tex=jnp.asarray(ja.tex_staged))
    want = [np.asarray(w) for w in want]
    # the port's texels carried over from the JAX atlas
    tex = from_jax_params(jax_fields_np(ja), "cpu", meta=tm).tex
    got = [g.numpy() for g in tg.grad_tiles(
        seed, *map(torch.from_numpy, tt), *map(torch.from_numpy, cots),
        meta=tm, cfg=tc, spp=spp, total_samples=spp, tile=GRAD_TILE,
        tex_grads=True, tex=tex,
        tex_table=torch.from_numpy(mk.build_tex_table(ta, tm)))]
    for g, w, what in zip(got[:2], want[:2], ("gcol", "gemi")):
        assert g.shape == w.shape and np.isfinite(g).all()
        err = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
        record_property(f"{what}_rel_err", err)
        assert err < GRAD_REL_MESH, (what, err)
    g = pack.texels_to_atlas(got[2], ta, tm, want[2].shape[1])
    w = want[2].astype(np.float64)
    touched = (g != 0) | (w != 0)
    assert touched.sum() >= 200, touched.sum()     # the sky is seen
    scale = np.abs(w).max()
    close = np.abs(g - w) <= 1e-3 * scale
    record_property("gtex_close_frac", float(close[touched].mean()))
    assert close[touched].mean() >= SLOT_FRAC, close[touched].mean()
    plane = w.shape[1] // 3         # the atlas's r | g | b lane planes
    for c in range(3):
        gs, ws = (a[:, c * plane:(c + 1) * plane].sum() for a in (g, w))
        record_property(f"gtex_sum_rel_err_{c}", float(abs(gs - ws) / ws))
        assert abs(gs - ws) < SUM_REL * abs(ws), (c, gs, ws)
    assert not got[2][~pack.trainable_texels(ta, tm).numpy()].any()
