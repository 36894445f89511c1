"""pathtracer_tpu_torch's texel gradients (K6-tex: grad_tiles(tex_grads=True),
make_diff_render_tex, make_megakernel_step_tex, train_demo --tex) against
the JAX package's.

On the CPU the port's grad_tiles runs its plain PyTorch version. It is held
against pallas_grad.grad_tiles(tex_grads=True, interpret=True) with the same
seed vector, layout (tile (8, 128), no sample packing) and per-slot
cotangents made with numpy, on `textures-train` (24x16, 2 spp; its 256x96
cobblestone spans two lane windows of the staged atlas) and on the
four-checker scene of tests/test_grad_pallas.py's texel tests (`textures`
with small file checkers and no normal maps). The port's texels are the JAX
atlas's values, carried over by from_jax_params. The two layouts are
compared in the atlas's through scene.pack.texels_to_atlas. Rule: gcol and
gemi within GRAD_REL_MESH (1e-3) * max|g|; >= 99% of the texels that
either side touches within 1e-3 * max|gtex|; each channel's gtex sum
within 1%. The JAX fetch blends y before x inside its one-hot matmuls and
XLA:CPU contracts its multiply-adds into FMAs, so the two are not bit for
bit; the measured errors are recorded as test properties.

The CUDA kernel is held against the plain version by tests/test_torch_cuda.py,
on a card.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_inputs_match, jax_fields_np, jax_pack,
                           scene_pair)
from _torch_scenes import GRAD_REL_MESH, SLOT_FRAC, grad_inputs, port_inputs
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu.render import proctex as jproctex
from pathtracer_tpu.render.pallas_grad import grad_tiles as jax_grad_tiles
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.diff import (SceneParams, from_jax_params,
                                       make_megakernel_step_tex)
from pathtracer_tpu_torch.render import grad as tg
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.render import proctex
from pathtracer_tpu_torch.scene import pack
from pathtracer_tpu_torch.scenes import get_scene

torch.set_num_threads(2)

TILE = (8, 128)
SUM_REL = 0.01


def _checkers(sc, make):
    """tests/test_grad_pallas.py's texel scene: `textures` without normal
    maps, every texture a small file checker (all stage at full size)."""
    for o in sc.objects:
        o.material.textured_nm = False
    mk_ = lambda d, h, w: np.asarray(make(("checker", d), h, w)).copy()
    sc.textures = [
        mk_((8, (0.9, 0.9, 0.9), (0.2, 0.2, 0.2)), 64, 64),
        mk_((8, (0.8, 0.5, 0.3), (0.3, 0.5, 0.8)), 64, 64),
        mk_((8, (0.7, 0.7, 0.2), (0.2, 0.7, 0.7)), 64, 64),
        mk_((8, (0.5, 0.5, 1.0), (0.5, 1.0, 0.5)), 64, 64),
    ]
    sc.sphere_textures = [
        mk_((8, (0.9, 0.6, 0.3), (0.1, 0.3, 0.6)), 64, 128),
        mk_((8, (0.8, 0.7, 0.5), (0.4, 0.3, 0.2)), 64, 128),
    ]
    return sc


def _pair(name, W, H, spp):
    """Both packages' scene `name` ("checkers": the four-checker scene)
    packed, with the tables checked equal. Returns (JAX tables, port
    tables, JAX arrays, JAX meta, JAX cfg, port arrays, port meta, port
    cfg, pid, port scene)."""
    kw = dict(width=W, height=H, samples=spp, samples_per_pass=spp)
    js, jc, ts, tc = scene_pair("textures" if name == "checkers" else name,
                                **kw)
    if name == "checkers":
        js, ts = _checkers(js, jproctex.make), _checkers(ts, proctex.make)
    ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device="cpu")
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    xs, ys, pid = mk.tile_pixel_layout(W, H, *TILE,
                                       order=mk.default_order(tm))
    jt = [pk.build_camera_vec(js.camera), pk.build_scene_table(ja, jm),
          *pk.build_mesh_tables(ja, jm), xs, ys]
    tt = [mk.build_camera_vec(ts.camera), mk.build_scene_table(ta, tm),
          *mk.build_mesh_tables(ta, tm), xs, ys]
    assert_inputs_match(jt, tt, tm)
    return jt, tt, ja, jm, jc, ta, tm, tc, pid, ts


@pytest.fixture(scope="module", params=["textures-train", "checkers"])
def parity(request):
    """Per scene: the JAX interpret-mode (gcol, gemi, gtex) and the port's
    inputs (its texels carried over from the JAX atlas)."""
    name = request.param
    jt, tt, ja, jm, jc, ta, tm, tc, pid, ts = _pair(name, 24, 16, 2)
    rng = np.random.default_rng(3)
    cots = [rng.random(tt[-2].shape).astype(np.float32) for _ in range(3)]
    seed = (3, 0)
    want = jax_grad_tiles(
        jnp.asarray(seed, jnp.int32), *map(jnp.asarray, jt),
        *map(jnp.asarray, cots), meta=jm, cfg=jc, spp=2, total_samples=2,
        tile=TILE, tex_grads=True, interpret=True,
        tex=jnp.asarray(ja.tex_staged))
    tex = from_jax_params(jax_fields_np(ja), "cpu", meta=tm).tex
    kw = dict(meta=tm, cfg=tc, spp=2, total_samples=2, tile=TILE,
              tex_grads=True, tex=tex,
              tex_table=torch.from_numpy(mk.build_tex_table(ta, tm)))
    args = (seed, *map(torch.from_numpy, tt), *map(torch.from_numpy, cots))
    return name, [np.asarray(w) for w in want], args, kw, ta, tm


def test_tex_grad_matches_jax_interpret(record_property, parity):
    name, want, args, kw, ta, tm = parity
    before = (tg.grad_tiles.launches, tg.grad_tiles.tex_launches)
    got = [g.numpy() for g in tg.grad_tiles(*args, **kw)]
    # CPU tensors never launch
    assert (tg.grad_tiles.launches, tg.grad_tiles.tex_launches) == before
    for g, w, what in zip(got[:2], want[:2], ("gcol", "gemi")):
        assert g.shape == w.shape and np.isfinite(g).all()
        err = float(np.abs(g - w).max() / np.abs(w).max())
        record_property(f"{what}_rel_err", err)
        assert err < GRAD_REL_MESH, (what, err)
    assert got[2].shape == (ta.tex_pool_u32.shape[0], 3)
    assert np.isfinite(got[2]).all()
    g = pack.texels_to_atlas(got[2], ta, tm, want[2].shape[1])
    w = want[2].astype(np.float64)
    touched = (g != 0) | (w != 0)
    assert touched.sum() >= 200, touched.sum()     # the textures are seen
    scale = np.abs(w).max()
    close = np.abs(g - w) <= 1e-3 * scale
    record_property("gtex_close_frac", float(close[touched].mean()))
    record_property("gtex_max_rel_err", float(np.abs(g - w).max() / scale))
    assert close[touched].mean() >= SLOT_FRAC, close[touched].mean()
    plane = w.shape[1] // 3
    for c in range(3):
        gs, ws = (a[:, c * plane:(c + 1) * plane].sum() for a in (g, w))
        record_property(f"gtex_sum_rel_err_{c}", float(abs(gs - ws) / ws))
        assert abs(gs - ws) < SUM_REL * abs(ws), (c, gs, ws)
    # every gradient the port gives lies in the atlas's staged texels
    assert not got[2][~pack.trainable_texels(ta, tm).numpy()].any()


def test_textured_objects_have_zero_color_grad(parity):
    # the texel overwrites a textured object's color, so its object-color
    # gradient is exactly zero, while its emission gradient flows
    name, want, args, kw, ta, tm = parity
    gcol, gemi, _ = tg.grad_tiles(*args, **kw)
    slots = sorted({s for (s, *_r) in tm.obj_tex})
    assert slots and not gcol[slots].any()
    assert gemi[slots].abs().max() > 0
    assert not want[0][slots].any()


@pytest.fixture(scope="module")
def fd_setup():
    """The autograd Function on the plain version on `textures-train`, a
    fixed per-slot weighted loss and its analytic texel gradient."""
    _, tt, _, _, _, ta, tm, tc, _, _ = _pair("textures-train", 24, 16, 2)
    t = [torch.from_numpy(a) for a in tt]
    table = torch.from_numpy(mk.build_tex_table(ta, tm))
    render = tg.make_diff_render_tex(tm, tc, 2, 2, TILE)
    rng = np.random.default_rng(5)
    wts = [torch.from_numpy(rng.random(t[-2].shape).astype(np.float32))
           for _ in range(3)]
    seed = (11, 0)

    def loss(tex):
        rgb = render.apply(ta.color, ta.emission, tex, seed, *t, table)
        return sum(torch.sum(x * w) for x, w in zip(rgb, wts))

    tex = pack.texel_params(ta).requires_grad_(True)
    (gt,) = torch.autograd.grad(loss(tex), (tex,))
    return loss, tex.detach(), gt


@pytest.mark.parametrize("rank", [0, 1])
def test_tex_grad_matches_finite_difference(fd_setup, rank):
    # the estimator is linear in the texels given the paths, so common
    # random numbers make central differences near exact
    loss, tex, gt = fd_setup
    assert torch.isfinite(gt).all() and gt.abs().max() > 0
    p = int(torch.argsort(gt.abs().reshape(-1), descending=True)[rank])
    i, c = divmod(p, 3)
    h = 2e-3
    delta = torch.zeros_like(tex)
    delta[i, c] = h
    with torch.no_grad():
        g_fd = float((loss(tex + delta) - loss(tex - delta)) / (2 * h))
    g_an = float(gt[i, c])
    scale = max(abs(g_fd), abs(g_an), 1e-3)
    assert abs(g_fd - g_an) / scale < 5e-2, (i, c, g_fd, g_an)


@pytest.mark.parametrize("name", ["textures-train", "textures"])
def test_f32_texel_forward_is_the_rgb8_forward(name):
    # with the texels set to the decoded pool, the f32-texel fetch renders
    # the rgb8 image bit for bit (`textures` also fetches normal maps)
    cfg = RenderConfig(width=24, height=16, samples=2, samples_per_pass=2)
    sc = get_scene(name, cfg)
    tabs, meta, _, kw = port_inputs(sc, cfg, None, torch.device("cpu"))
    arrays, _ = sc.pack(device="cpu")
    kw.update(meta=meta, cfg=cfg, spp=2, total_samples=2,
              tile=mk.default_tile(meta))
    want = mk.trace_tiles((4, 0), *tabs, **kw)
    kw.pop("tex_pool")
    got = mk.trace_tiles((4, 0), *tabs, **kw,
                         tex_texels=pack.texel_params(arrays))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="either"):
        mk.trace_tiles((4, 0), *tabs, **kw)          # neither pool nor texels
    with pytest.raises(IndexError):                   # texels too few
        mk.trace_tiles((4, 0), *tabs, **kw,
                       tex_texels=pack.texel_params(arrays)[:1000])


def test_procedural_texels_get_exact_zeros():
    # `textures` with one planar texture made a file image (staged) and the
    # rest procedural: only the staged one's texels take gradients
    cfg = RenderConfig(width=16, height=12, samples=1, samples_per_pass=1)
    sc = get_scene("textures", cfg)
    for o in sc.objects:
        o.material.textured_nm = False
    sc.textures = [np.asarray(sc.textures[0]).copy()] + sc.textures[1:]
    tabs, meta, arrays, _ = grad_inputs(sc, cfg, TILE, "cpu")
    staged = pack.staged_objects(meta)
    procedural = [s for (s, d, *_r) in meta.obj_tex if s not in staged]
    assert staged and procedural
    train = pack.trainable_texels(arrays, meta)
    assert 0 < int(train.sum()) < train.numel()
    rng = np.random.default_rng(6)
    cots = [torch.from_numpy(rng.random(tuple(tabs[-2].shape))
                             .astype(np.float32)) for _ in range(3)]
    gcol, gemi, gtex = tg.grad_tiles(
        (2, 0), *tabs, *cots, meta=meta, cfg=cfg, spp=1, total_samples=1,
        tile=TILE, tex_grads=True, tex=pack.texel_params(arrays),
        tex_table=torch.from_numpy(mk.build_tex_table(arrays, meta)))
    assert gtex[train].abs().max() > 0
    assert not gtex[~train].any()
    # procedural textured objects that were hit: emission flows, color not
    hit = [s for s in procedural if gemi[s].abs().max() > 0]
    assert hit and not gcol[hit].any()


def test_atlas_maps_round_trip():
    # textures-train: every staged texel crosses from the atlas to the
    # texels and back; the cobblestone (96x256) spans two lane windows
    js, _, ts, _ = scene_pair("textures-train", width=8, height=6)
    ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device="cpu")
    atlas = np.asarray(ja.tex_staged)
    tall = [d for (_s, d, *_r) in tm.obj_tex if d[3] > 128]
    assert tall and tall[0][2:] == (96, 256)
    tex = pack.atlas_to_texels(atlas, ta, tm)
    back = pack.texels_to_atlas(tex, ta, tm, atlas.shape[1])
    staged = np.zeros(atlas.shape, bool)
    plane = atlas.shape[1] // 3
    for (_s, d, *_r) in tm.obj_tex:
        _, lane, w, h = d
        hb = -(-h // 128)
        for c in range(3):
            staged[:min(h, 128), c * plane + lane:
                   c * plane + lane + hb * w] = True
    assert np.array_equal(back[staged], atlas[staged].astype(np.float64))
    assert not back[~staged].any()
    train = pack.trainable_texels(ta, tm)
    again = pack.atlas_to_texels(back, ta, tm)
    assert torch.equal(again[train], tex[train])
    # texels off the staged textures keep the decoded pool
    assert torch.equal(tex[~train], pack.texel_params(ta)[~train])
    # the cobblestone's row 200, column 5 sits in its second window
    slot = next(s for (s, d, *_r) in tm.obj_tex if d[3] > 128)
    b = int(ta.tex_base[slot])
    assert float(tex[b + 200 * 96 + 5, 1]) == atlas[200 - 128, plane
                                                    + tall[0][1] + 96 + 5]


def test_params_carry_the_atlas_values():
    js, _, ts, _ = scene_pair("textures-train", width=8, height=6)
    ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device="cpu")
    p = from_jax_params(jax_fields_np(ja), "cpu", meta=tm)
    assert isinstance(p, SceneParams) and p.tex.dtype == torch.float32
    decoded = pack.texel_params(ta)
    train = pack.trainable_texels(ta, tm)
    # the atlas decodes f32(q) / f32(255): one ulp off the pool's q *
    # f32(1/255) on some texels, which carry over as the atlas has them
    diff = (p.tex != decoded).any(dim=1)
    assert diff.any() and not diff[~train].any()
    assert (p.tex - decoded).abs().max() < 1e-7
    # without the meta the texels are the decoded pool
    assert torch.equal(from_jax_params(jax_fields_np(ja), "cpu").tex,
                       decoded)


def test_mip_staged_texture_trains_at_full_resolution():
    # envmap-file's 2048x1024 sky is staged by the JAX package as a 128x64
    # mip; here its full-resolution texels train, and no atlas texel maps
    # onto them (no parity case exists for such a texture)
    sc = get_scene("envmap-file", RenderConfig(width=8, height=6))
    arrays, meta = sc.pack(device="cpu")
    (slot,) = pack.staged_objects(meta)
    desc = next(d for (s, d, *_r) in meta.obj_tex if s == slot)
    assert desc[2:] == (128, 64)
    assert int(pack.trainable_texels(arrays, meta).sum()) == 2048 * 1024
    assert not pack.texels_to_atlas(pack.texel_params(arrays), arrays, meta,
                                    384).any()


def test_tex_step_descends():
    """make_megakernel_step_tex: SGD on perturbed texels toward a true-texel
    target with the same seed (common random numbers) shrinks the loss by
    at least 10% over 3 steps. The object colors stay at their true values:
    the texels' step size would throw them off."""
    W, H, spp = 32, 24, 2
    cfg = RenderConfig(width=W, height=H, samples=spp, samples_per_pass=spp)
    sc = get_scene("textures-train", cfg)
    tabs, meta, arrays, pid = grad_inputs(sc, cfg, TILE, "cpu")
    step, target_of = make_megakernel_step_tex(arrays, meta, cfg, sc.camera,
                                               spp=spp, tile=TILE, lr=100.0)
    tex = pack.texel_params(arrays)
    render = tg.make_diff_render_tex(meta, cfg, spp, spp, TILE)
    table = torch.from_numpy(mk.build_tex_table(arrays, meta))
    seed = (7, 0)
    with torch.no_grad():
        rgb = render.apply(arrays.color, arrays.emission, tex, seed, *tabs,
                           table)
    flat = torch.stack(rgb, dim=-1).reshape(-1, 3).numpy() / spp
    target = target_of(mk.untile_image(flat, pid, W, H).reshape(H, W, 3))
    train = pack.trainable_texels(arrays, meta)
    rng = np.random.default_rng(7)
    t = tex.clone()
    t[train] = torch.clamp(t[train] + torch.from_numpy(rng.uniform(
        -0.3, 0.3, (int(train.sum()), 3)).astype(np.float32)), 0.0, 1.0)
    losses = []
    for _ in range(3):
        _, _, t, loss = step(arrays.color, arrays.emission, t, seed, target)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[0] > 0
    assert losses[-1] < losses[0] * 0.9, losses
    assert torch.equal(t[~train], tex[~train])     # exactly-zero gradients


def test_train_demo_tex_on_cpu(tmp_path):
    out = tmp_path / "strip.png"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.train_demo", "--tex",
         "--device", "cpu", "--width", "16", "--height", "12", "--spp", "2",
         "--steps", "3", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=root,
        env={**os.environ, "PYTHONPATH": root})
    assert res.returncode == 0, res.stderr[-2000:]
    m = re.search(r"loss ([0-9.]+) -> ([0-9.]+); texel MAD "
                  r"([0-9.]+) -> ([0-9.]+)", res.stdout)
    assert m, res.stdout[-2000:]
    assert float(m.group(2)) < float(m.group(1))
    assert out.exists() and out.stat().st_size > 0


def _refusal_scene(case, cfg):
    if case == "normal maps":
        return get_scene("textures-file", cfg)
    if case == "no staged texture":
        # `textures` without its normal maps: every texture procedural
        sc = get_scene("textures", cfg)
        for o in sc.objects:
            o.material.textured_nm = False
        return sc
    return get_scene("textures-train", cfg)


@pytest.mark.parametrize("case,err,match", [
    ("nee", NotImplementedError, "does not replay NEE"),
    ("normal maps", NotImplementedError, "normal maps"),
    ("no staged texture", ValueError, "staged texture"),
    ("with tri_grads", ValueError, "tri_grads")])
def test_tex_refusals(case, err, match):
    cfg = RenderConfig(width=16, height=12, samples=1, samples_per_pass=1,
                       nee=case == "nee")
    tabs, meta, arrays, _ = grad_inputs(_refusal_scene(case, cfg), cfg, TILE,
                                        "cpu")
    if case != "with tri_grads":
        with pytest.raises(err, match=match):
            tg.make_diff_render_tex(meta, cfg, 1, 1, TILE)
    zero = torch.zeros(tuple(tabs[-2].shape), dtype=torch.float32)
    with pytest.raises(err, match=match):
        tg.grad_tiles((1, 0), *tabs, zero, zero, zero, meta=meta, cfg=cfg,
                      spp=1, total_samples=1, tile=TILE, tex_grads=True,
                      tri_grads=case == "with tri_grads",
                      tex=pack.texel_params(arrays),
                      tex_table=torch.from_numpy(
                          mk.build_tex_table(arrays, meta)))
