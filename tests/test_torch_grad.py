"""pathtracer_tpu_torch's differentiable megakernel (render/grad.py,
diff/grad.py) against the JAX package's, object color and emission.

On the CPU the port's grad_tiles runs grad_tiles_reference, its plain
PyTorch version; it is held against pallas_grad.grad_tiles(interpret=True)
with the same seed vector, layout (tile (8, 128), no sample packing) and
per-slot cotangents made with numpy, on `reference` (32x24, 4 spp), on
`reference` with depth of field (its camera vector, sample base 16) and on
`reference` with a glass and a mirror sphere (the object table's
refraction and reflection columns). The three share the JAX kernel's
static arguments, so it compiles once for the module. Rule: gcol and gemi
within 1e-4 * max|g| (the two sum the same per-slot values in another
order).

Central finite differences (h = 2e-3, relative error < 5e-2) check the
autograd Function on the plain version: the estimator is multilinear in
the colors and, for objects that already emit, in the emission, so with
common random numbers the differences are near exact (emission is
one-sided at 0, tests/test_grad_pallas.py:71-77). The CUDA kernel is held
against the plain version by tests/test_torch_cuda.py, on a card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_inputs_match, jax_fields_np, jax_pack,
                           scene_pair)
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu.render.pallas_grad import _assemble_obj as jax_assemble
from pathtracer_tpu.render.pallas_grad import grad_tiles as jax_grad_tiles
from pathtracer_tpu_torch.diff import (SceneParams, from_jax_params,
                                       make_megakernel_step)
from pathtracer_tpu_torch.render import grad as tg
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scene.pack import texel_params

torch.set_num_threads(2)

TILE = (8, 128)
W, H, SPP = 32, 24, 4
TOTAL = SPP + 16        # one total_samples for every case: one JAX compile
REL = 1e-4


def _tables(js, ts, jm, tm, ja, ta):
    xs, ys, pid = mk.tile_pixel_layout(W, H, *TILE,
                                       order=mk.default_order(tm))
    jt = [pk.build_camera_vec(js.camera), pk.build_scene_table(ja, jm),
          *pk.build_mesh_tables(ja, jm), xs, ys]
    tt = [mk.build_camera_vec(ts.camera), mk.build_scene_table(ta, tm),
          *mk.build_mesh_tables(ta, tm), xs, ys]
    assert_inputs_match(jt, tt, tm)
    return jt, tt, pid


@pytest.fixture(scope="module")
def parity():
    """Per case: the port's tables (numpy), seed, cotangents, and the JAX
    interpret-mode (gcol, gemi)."""
    js, jc, ts, tc = scene_pair("reference", width=W, height=H, samples=SPP,
                                samples_per_pass=SPP)
    ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device="cpu")
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    jtabs, tabs, pid = _tables(js, ts, jm, tm, ja, ta)
    dof_js, _, dof_ts, _ = scene_pair("reference", width=W, height=H,
                                      samples=SPP, aperture=0.1,
                                      focal_length=1.6)
    dof_cam = mk.build_camera_vec(dof_ts.camera)
    assert np.array_equal(dof_cam, pk.build_camera_vec(dof_js.camera))
    glass = tabs[1].copy()
    spheres = [j for j, t in enumerate(tm.obj_types) if t == 1
               and glass[j, 27] == 0.0]
    assert len(spheres) >= 2
    glass[spheres[0], 30] = 1.5          # solid glass: Schlick refraction
    glass[spheres[1], 31] = 0.9          # mirror
    # (seed, the JAX kernel's tables, the port's)
    cases = {"reference": ((3, 0), jtabs, tabs),
             "dof": ((3, 16), [dof_cam] + jtabs[1:], [dof_cam] + tabs[1:]),
             "glass": ((5, 0), [jtabs[0], glass] + jtabs[2:],
                       [tabs[0], glass] + tabs[2:])}
    rng = np.random.default_rng(0)
    out = {}
    for name, (seed, jt, t) in cases.items():
        cots = [rng.random(t[-2].shape).astype(np.float32) for _ in range(3)]
        want = jax_grad_tiles(
            jnp.asarray(seed, jnp.int32), *map(jnp.asarray, jt),
            *map(jnp.asarray, cots), meta=jm, cfg=jc, spp=SPP,
            total_samples=TOTAL, tile=TILE, interpret=True)
        out[name] = (seed, t, cots, [np.asarray(w) for w in want])
    return out, tm, tc, ta, ja, pid


def _port(t, seed, cots, meta, cfg):
    return tg.grad_tiles(seed, *map(torch.from_numpy, t),
                         *map(torch.from_numpy, cots), meta=meta, cfg=cfg,
                         spp=SPP, total_samples=TOTAL, tile=TILE)


@pytest.mark.parametrize("name", ["reference", "dof", "glass"])
def test_grad_matches_jax_interpret(parity, name):
    cases, tm, tc, *_ = parity
    seed, t, cots, want = cases[name]
    before = tg.grad_tiles.launches
    got = _port(t, seed, cots, tm, tc)
    assert tg.grad_tiles.launches == before      # CPU tensors never launch
    for g, w, what in zip(got, want, ("gcol", "gemi")):
        g = g.numpy()
        assert g.shape == w.shape == (tm.n_objects, 3)
        assert np.isfinite(g).all() and np.abs(w).max() > 0
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err < REL, (what, err)


def test_glass_case_refracts(parity):
    # the glass case must take other paths than the plain scene
    cases, tm, tc, *_ = parity
    a = cases["reference"][3][0]
    b = cases["glass"][3][0]
    assert not np.allclose(a, b)


def test_assemble_obj_keeps_all_columns(parity):
    cases, tm, _, ta, ja, _ = parity
    obj = torch.from_numpy(cases["reference"][1][1])
    rng = np.random.default_rng(4)
    color = rng.random((tm.max_objects, 3)).astype(np.float32)
    emission = rng.random((tm.max_objects, 3)).astype(np.float32)
    got = tg._assemble_obj(obj, torch.from_numpy(color),
                           torch.from_numpy(emission), tm.n_objects).numpy()
    want = np.asarray(jax_assemble(jnp.asarray(obj.numpy()),
                                   jnp.asarray(color), jnp.asarray(emission),
                                   tm.n_objects))
    assert got.shape == (tm.n_objects, 45) and want.shape[1] == 40
    assert np.array_equal(got[:, :40], want)
    assert np.array_equal(got[:, 40:], obj.numpy()[:, 40:])


def test_params_carry_over_from_jax(parity):
    _, tm, _, ta, ja, _ = parity
    p = from_jax_params(jax_fields_np(ja), "cpu")
    assert isinstance(p, SceneParams)
    for k in ("color", "emission", "tri_color"):
        assert torch.equal(getattr(p, k), getattr(ta, k))
    # the texels: the pool decoded (an untextured scene's one-texel pool)
    assert torch.equal(p.tex, texel_params(ta))


@pytest.fixture(scope="module")
def fd_setup(parity):
    """The autograd Function on the plain version, a fixed per-slot
    weighted loss and its analytic gradient."""
    cases, tm, tc, ta, _, _ = parity
    t = [torch.from_numpy(a) for a in cases["reference"][1]]
    render = tg.make_diff_render(tm, tc, SPP, SPP, TILE)
    rng = np.random.default_rng(0)
    wts = [torch.from_numpy(rng.random(t[-2].shape).astype(np.float32))
           for _ in range(3)]
    seed = (3, 0)

    def loss(c, e):
        rgb = render.apply(c, e, seed, *t)
        return sum(torch.sum(x * w) for x, w in zip(rgb, wts))

    color = ta.color.clone().requires_grad_(True)
    emission = ta.emission.clone().requires_grad_(True)
    gc, ge = torch.autograd.grad(loss(color, emission), (color, emission))
    return loss, ta.color, ta.emission, gc, ge


@pytest.mark.parametrize("which,j,c", [
    ("color", 1, 0), ("color", 6, 2), ("color", 0, 1), ("color", 7, 0),
    ("emission", 0, 0), ("emission", 0, 1), ("emission", 0, 2)])
def test_grad_matches_finite_difference(fd_setup, which, j, c):
    loss, color, emission, gc, ge = fd_setup
    assert torch.isfinite(gc).all() and torch.isfinite(ge).all()
    h = 2e-3
    base = color if which == "color" else emission
    delta = torch.zeros_like(base)
    delta[j, c] = h
    with torch.no_grad():
        if which == "color":
            lp, lm = loss(color + delta, emission), loss(color - delta,
                                                         emission)
            g_an = float(gc[j, c])
        else:
            lp, lm = loss(color, emission + delta), loss(color,
                                                         emission - delta)
            g_an = float(ge[j, c])
    g_fd = float((lp - lm) / (2 * h))
    scale = max(abs(g_fd), abs(g_an), 1e-3)
    assert abs(g_fd - g_an) / scale < 5e-2, (which, j, c, g_fd, g_an)


def test_forward_is_the_megakernel(fd_setup, parity):
    # the Function's primal is trace_tiles on the assembled table, and a
    # loss that reads one channel still gets the gradient of that channel
    cases, tm, tc, ta, _, _ = parity
    t = [torch.from_numpy(a) for a in cases["reference"][1]]
    render = tg.make_diff_render(tm, tc, SPP, SPP, TILE)
    assert render is tg.make_diff_render(tm, tc, SPP, SPP, TILE)
    color = ta.color.clone().requires_grad_(True)
    r, g, b = render.apply(color, ta.emission, (3, 0), *t)
    want = mk.trace_tiles_reference((3, 0), *t, meta=tm, cfg=tc, spp=SPP,
                                    total_samples=SPP, tile=TILE)
    for x, y in zip((r, g, b), want):
        assert torch.equal(x.detach(), y)
    (gc,) = torch.autograd.grad(r.sum(), (color,))
    zero = torch.zeros_like(t[-2], dtype=torch.float32)
    want_gc, _ = tg.grad_tiles_reference(
        (3, 0), *t, torch.ones_like(zero), zero, zero, meta=tm, cfg=tc,
        spp=SPP, total_samples=SPP, tile=TILE)
    assert torch.equal(gc[:tm.n_objects], want_gc)
    assert not gc[tm.n_objects:].any() and not gc[:, 1:].any()


def test_step_descends(parity):
    """make_megakernel_step: 3 SGD steps from perturbed colors toward a
    true-color target with the same seed (common random numbers) shrink
    the loss by at least 10%."""
    cases, tm, tc, ta, _, pid = parity
    ts = scene_pair("reference", width=W, height=H, samples=SPP,
                    samples_per_pass=SPP)[2]
    step, target_of = make_megakernel_step(ta, tm, tc, ts.camera, spp=SPP,
                                           tile=TILE, lr=0.2)
    t = [torch.from_numpy(a) for a in cases["reference"][1]]
    render = tg.make_diff_render(tm, tc, SPP, tc.samples, TILE)
    seed = (7, 0)
    with torch.no_grad():
        rgb = render.apply(ta.color, ta.emission, seed, *t)
    flat = torch.stack(rgb, dim=-1).reshape(-1, 3).numpy() / SPP
    img = mk.untile_image(flat, pid, W, H).reshape(H, W, 3)
    target = target_of(img)
    c = ta.color.clone()
    c[1, 0] += 0.3
    c[6, 2] -= 0.2
    e = ta.emission
    losses = []
    for _ in range(3):
        c, e, loss = step(c, e, seed, target)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses


def test_refusals(parity):
    cases, tm, tc, *_ = parity
    seed, t, cots, _ = cases["reference"]
    with pytest.raises(NotImplementedError, match="does not replay NEE"):
        tg.make_diff_render(tm, tc.replace(nee=True), SPP, SPP, TILE)
    # a textured scene is differentiated in texel mode
    with pytest.raises(NotImplementedError, match="make_diff_render_tex"):
        tg.make_diff_render(dataclasses.replace(tm, textured_types=(1,)),
                            tc, SPP, SPP, TILE)
    # which needs a staged texture
    with pytest.raises(ValueError, match="staged texture"):
        tg.grad_tiles(seed, *map(torch.from_numpy, t),
                      *map(torch.from_numpy, cots), meta=tm, cfg=tc,
                      spp=SPP, total_samples=SPP, tile=TILE, tex_grads=True)
    with pytest.raises(ValueError, match="tri_mode"):
        tg.grad_tiles(seed, *map(torch.from_numpy, t),
                      *map(torch.from_numpy, cots), meta=tm, cfg=tc,
                      spp=SPP, total_samples=SPP, tile=TILE,
                      tri_mode="scatter")
    with pytest.raises(ValueError, match="cot_g"):
        tg.grad_tiles(seed, *map(torch.from_numpy, t),
                      torch.from_numpy(cots[0]),
                      torch.from_numpy(cots[1]).t(),
                      torch.from_numpy(cots[2]), meta=tm, cfg=tc, spp=SPP,
                      total_samples=SPP, tile=TILE)
