"""pathtracer_tpu_torch's differentiable megakernel in triangle mode
(make_diff_render_tri, make_megakernel_step_tri, train_demo --tri) against
the JAX package's, on `teapot` (a 1472-triangle UV sphere stands in for
teapot.obj).

On the CPU the port's grad_tiles(tri_grads=True) runs its plain PyTorch
version; it is held against pallas_grad.grad_tiles(tri_grads=True,
interpret=True) at 128x96, 2 spp, tile (8, 128), with the same seed vector
and per-slot cotangents made with numpy. The JAX scene is packed on its
NumPy path (native scene-core off) and handed the port's group bounds, as
tests/test_torch_mesh_*.py do (its Python path packs NaN bounds for parsed
models, ROADMAP queue 3). The BVH walks differ in order only (one pointer
per packet there, one per ray here), which matters on exact-t ties, so the
rule is: gcol and gemi within 1e-3 * max|g|, and >= 99% of the triangle
slots' gradients within 1e-3 * max|gtri|. Central finite differences check
the two largest triangle gradients through the autograd Function.
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

from _torch_parity import assert_inputs_match, jax_twin
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu.render.pallas_grad import grad_tiles as jax_grad_tiles
from pathtracer_tpu_torch import train_demo
from pathtracer_tpu_torch.diff import make_megakernel_step_tri
from pathtracer_tpu_torch.render import grad as tg
from pathtracer_tpu_torch.render import megakernel as mk

torch.set_num_threads(2)

TILE = (8, 128)
REL = 1e-3
SLOT_FRAC = 0.99


def _mesh_pair(W, H, spp):
    """(JAX tables, port tables, JAX meta, port meta, port arrays, cfgs,
    pid, port scene) for `teapot`, the JAX scene carrying the port's group
    bounds."""
    js, jc, ja, jm, ts, tc = jax_twin("teapot", width=W, height=H,
                                      samples=spp, samples_per_pass=spp)
    ta, tm = ts.pack(device="cpu")
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert tm.has_groups
    tobj = mk.build_scene_table(ta, tm)
    xs, ys, pid = mk.tile_pixel_layout(W, H, *TILE,
                                       order=mk.default_order(tm))
    jt = [pk.build_camera_vec(js.camera), pk.build_scene_table(ja, jm),
          *pk.build_mesh_tables(ja, jm), xs, ys]
    tt = [mk.build_camera_vec(ts.camera), tobj,
          *mk.build_mesh_tables(ta, tm), xs, ys]
    assert_inputs_match(jt, tt, tm)
    return jt, tt, jm, tm, ta, jc, tc, pid, ts


@pytest.fixture(scope="module")
def parity():
    W, H, spp = 128, 96, 2
    jt, tt, jm, tm, ta, jc, tc, _, _ = _mesh_pair(W, H, spp)
    rng = np.random.default_rng(1)
    cots = [rng.random(tt[-2].shape).astype(np.float32) for _ in range(3)]
    seed = (9, 0)
    want = jax_grad_tiles(
        jnp.asarray(seed, jnp.int32), *map(jnp.asarray, jt),
        *map(jnp.asarray, cots),
        meta=dataclasses.replace(jm, tri_uniform_color=None), cfg=jc,
        spp=spp, total_samples=spp, tile=TILE, tri_grads=True,
        interpret=True)
    kw = dict(meta=tm, cfg=tc, spp=spp, total_samples=spp, tile=TILE,
              tri_grads=True)
    args = (seed, *map(torch.from_numpy, tt), *map(torch.from_numpy, cots))
    return [np.asarray(w) for w in want], args, kw


def test_tri_grad_matches_jax_interpret(parity):
    want, args, kw = parity
    got = [g.numpy() for g in tg.grad_tiles(*args, **kw)]
    for g, w, what in zip(got[:2], want[:2], ("gcol", "gemi")):
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.abs(g - w).max() / np.abs(w).max() < REL, what
    g, w = got[2], want[2]
    assert g.shape == w.shape == (kw["meta"].n_tri_slots, 3)
    assert np.isfinite(g).all()
    hit = (np.abs(w) > 0).any(axis=1)
    assert hit.sum() >= 20, hit.sum()           # the mesh is on screen
    close = (np.abs(g - w) <= REL * np.abs(w).max()).all(axis=1)
    assert close.mean() >= SLOT_FRAC, close.mean()
    assert close[hit].mean() >= SLOT_FRAC, close[hit].mean()


def test_tri_modes_are_one_scatter(parity):
    # PT_TRI_GRAD's onehot and tape modes were two TPU scatters of the
    # same sums; both are the atomic add here
    _, args, kw = parity
    a = tg.grad_tiles(*args, **kw, tri_mode="onehot")
    b = tg.grad_tiles(*args, **kw, tri_mode="tape")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # object mode gives the same object gradients
    c = tg.grad_tiles(*args, **{**kw, "tri_grads": False})
    assert len(c) == 2
    for x, y in zip(a[:2], c):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def fd_setup():
    W, H, spp = 16, 12, 2
    _, tt, _, tm, ta, _, tc, pid, ts = _mesh_pair(W, H, spp)
    t = [torch.from_numpy(a) for a in tt]
    render = tg.make_diff_render_tri(tm, tc, spp, TILE, spp=spp)
    rng = np.random.default_rng(2)
    wts = [torch.from_numpy(rng.random(t[-2].shape).astype(np.float32))
           for _ in range(3)]
    seeds = [(40 + i, i) for i in range(2)]

    def loss(tc_):
        tot = 0.0
        for sd in seeds:
            rgb = render.apply(ta.color, ta.emission, tc_, sd, *t)
            tot = tot + sum(torch.sum(x * w) for x, w in zip(rgb, wts))
        return tot

    tri = ta.tri_color.clone().requires_grad_(True)
    (gt,) = torch.autograd.grad(loss(tri), (tri,))
    return loss, ta.tri_color, gt


@pytest.mark.parametrize("rank", [0, 1])
def test_tri_grad_matches_finite_difference(fd_setup, rank):
    loss, tri, gt = fd_setup
    assert torch.isfinite(gt).all() and gt.abs().max() > 0
    p = int(torch.argsort(gt.abs().reshape(-1), descending=True)[rank])
    s, c = divmod(p, 3)
    h = 2e-3
    delta = torch.zeros_like(tri)
    delta[s, c] = h
    with torch.no_grad():
        g_fd = float((loss(tri + delta) - loss(tri - delta)) / (2 * h))
    g_an = float(gt[s, c])
    scale = max(abs(g_fd), abs(g_an), 1e-3)
    assert abs(g_fd - g_an) / scale < 5e-2, (s, c, g_fd, g_an)


def test_tri_step_descends():
    """make_megakernel_step_tri: SGD on perturbed triangle colors toward a
    true-color target with the same seeds (common random numbers) shrinks
    the loss. The object colors stay at their true values: the stand-in
    covers few pixels, so the triangle gradients are small and take a
    step size that would throw the walls' colors off."""
    W, H, spp = 64, 48, 2
    _, tt, _, tm, ta, _, tc, pid, ts = _mesh_pair(W, H, spp)
    step, target_of = make_megakernel_step_tri(
        ta, tm, tc, ts.camera, n_passes=2, tile=TILE, lr=100.0, spp=spp)
    t = [torch.from_numpy(a) for a in tt]
    render = tg.make_diff_render_tri(tm, tc, 2 * spp, TILE, spp=spp)
    seed = (11, 0)
    with torch.no_grad():
        acc = 0
        for i in range(2):
            rgb = render.apply(ta.color, ta.emission, ta.tri_color,
                               (seed[0] + i * 7919, seed[1] + i * spp), *t)
            acc = acc + torch.stack(rgb, dim=-1)
    img = mk.untile_image(acc.reshape(-1, 3).numpy() / (2 * spp), pid, W,
                          H).reshape(H, W, 3)
    target = target_of(img)
    tri = ta.tri_color.clone()
    tri[:, 0] -= 0.3
    losses = []
    for _ in range(3):
        _, _, tri, loss = step(ta.color, ta.emission, tri, seed, target)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[0] > 0
    assert losses[-1] < losses[0] * 0.9, losses


def test_train_demo_tri_on_cpu(tmp_path):
    out = tmp_path / "strip.png"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.train_demo", "--tri",
         "--device", "cpu", "--width", "16", "--height", "12", "--spp", "2",
         "--steps", "3", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=root,
        env={**os.environ, "PYTHONPATH": root})
    assert res.returncode == 0, res.stderr[-2000:]
    m = re.search(r"loss ([0-9.]+) -> ([0-9.]+); tri-color MAD "
                  r"([0-9.]+) -> ([0-9.]+)", res.stdout)
    assert m, res.stdout[-2000:]
    assert float(m.group(2)) < float(m.group(1))
    assert out.exists() and out.stat().st_size > 0


@pytest.mark.parametrize("argv,item", [
    # the default (wavefront autograd) mode is ported: what it refuses
    (["--scene", "teapot"], "trains `reference`"),
    (["--tri", "--checkpoint", "ck"], "the default mode's"),
    (["--tri", "--tex"], "separate modes")])
def test_train_demo_unported_modes_exit_2(capsys, argv, item):
    assert train_demo.main(argv) == 2
    assert item in capsys.readouterr().err


def test_mxu_traversal_refused(monkeypatch):
    _, _, _, tm, _, _, tc, _, _ = _mesh_pair(16, 12, 1)
    monkeypatch.setenv("PT_TRAVERSAL", "mxu")
    # the JAX package's differentiable kernel refuses MXU leaves the same
    # way (pallas_grad.py:1151)
    with pytest.raises(NotImplementedError, match="classic-traversal only"):
        tg.make_diff_render_tri(tm, tc, 3, TILE)
