"""The object loop's filter (csrc/megakernel.cu plane_skip, round_skip),
held on the CPU without JAX.

The kernel skips a plane's, sphere's or cylinder's exact test where the
filter shows, from undivided f32 products, that the test cannot give a t
below the running winner's (T). A numpy float32 copy of the filter, with
the CUDA helper's expressions, is checked here against the plain tests
(_plane_t, _sphere_t, _cylinder_t) on seeded random and adversarial cases
(tests/_torch_scenes.filter_cases): wherever it skips, the exact t is at
least T (or kBig). The copy must equal the package's plain filter
(megakernel.object_skip), which filter_check runs on the CPU, bit for bit;
a filtered copy of the object loop must give _nearest_hit's winner and t
on the rays of `reference` and `default`; and each margin of the filter is
needed: without it, the cases find a skipped winner. The card holds the
CUDA filter to the exact tests over 2^28 cases a type (chip_smoke.py,
tests/test_torch_cuda.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_scenes import bounce_rays, camera_rays, filter_cases
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scene.shapes import BOX, CYLINDER, GROUP, PLANE, \
    SPHERE
from pathtracer_tpu_torch.scenes import get_scene

torch.set_num_threads(2)

EPS, T_MAX, BIG = 1e-4, 1024.0, 1e30
MIN_Y, MAX_Y = 0.0, 0.4          # the cylinder's y range in the cases
N_CASES = 350_000                # a type: about 10^6 cases in all
CODES = {"plane": PLANE, "sphere": SPHERE, "cylinder": CYLINDER}

f32 = np.float32
K_SHRINK = f32(1.0 - 2.0 ** -21)
K_MISS = f32(2.0 ** -12)
K_GROW = f32(1.0 + 2.0 ** -19)
K_FAR = f32(2.0 ** -16)


# ---- the numpy float32 copy of the CUDA helpers ---------------------------

def plane_skip(oy, dy, T):
    lim = T * np.abs(dy)
    return (((oy.view(np.int32) ^ dy.view(np.int32)) >= 0)
            | ((np.abs(oy) * K_SHRINK >= lim) & (lim >= f32(2.0 ** -126))))


def round_skip(a, b, c, T):
    ca = c * a
    sane = (a >= f32(2.0 ** -40)) & (ca <= f32(2.0 ** 100))
    miss = ca - b * b >= a + K_MISS * ca
    y = -b - T * (a * K_GROW)
    far = (y > f32(0)) & (y * y >= a * (f32(1) + K_FAR * (f32(1) + c)))
    return sane & (miss | far)


def object_skip(code, T, ox, oy, oz, dx, dy, dz):
    if code == PLANE:
        return plane_skip(oy, dy, T)
    if code == SPHERE:
        return round_skip(dx * dx + dy * dy + dz * dz,
                          ox * dx + oy * dy + oz * dz,
                          ox * ox + oy * oy + oz * oz, T)
    return round_skip(dx * dx + dz * dz, ox * dx + oz * dz,
                      ox * ox + oz * oz, T)


def _cases(code, seed=0, n=N_CASES):
    ray, T = filter_cases(code, n, seed, "cpu", EPS, MIN_Y, MAX_Y)
    return ray, T


def _exact_t(code, ray):
    return mk._primitive_t(code, [0.0] * 32 + [MIN_Y, MAX_Y], EPS, *ray)


def _np(x):
    return x.numpy().astype(np.float32, copy=False)


@pytest.mark.parametrize("name", list(CODES))
def test_filter_never_skips_a_winner(name):
    code = CODES[name]
    ray, T = _cases(code)
    with np.errstate(all="ignore"):
        skip = object_skip(code, _np(T), *(_np(r) for r in ray))
    t = _exact_t(code, ray).numpy()
    missed = skip & (t < T.numpy())
    assert not missed.any(), (int(missed.sum()), np.flatnonzero(missed)[:5])
    # the filter does skip, in every mode of the cases
    assert skip.mean() > 0.2


@pytest.mark.parametrize("name", list(CODES))
def test_copy_is_the_plain_filter(name):
    # the numpy copy and the package's plain filter (filter_check's CPU
    # path) agree on every case, so the CPU proof is the kernel's filter's
    code = CODES[name]
    ray, T = _cases(code, seed=1)
    with np.errstate(all="ignore"):
        want = object_skip(code, _np(T), *(_np(r) for r in ray))
    got = mk.object_skip(code, T, *ray).numpy()
    assert np.array_equal(got, want)
    skipped, bad = mk.filter_check(code, ray, T, EPS, MIN_Y, MAX_Y)
    assert (skipped, bad) == (int(want.sum()), 0)


@pytest.mark.parametrize("name,const,value", [
    ("plane", "_K_SHRINK", 1.0),
    ("sphere", "_K_MISS", 0.0),
    ("cylinder", "_K_MISS", 0.0),
    ("sphere", "_K_FAR", 0.0),
    ("cylinder", "_K_FAR", 0.0),
])
def test_each_margin_is_needed(monkeypatch, name, const, value):
    # the cases reach the filter's bounds: with a margin taken away (the
    # far test's two), the filter skips exact winners
    monkeypatch.setattr(mk, const, value)
    if const == "_K_FAR":
        monkeypatch.setattr(mk, "_K_GROW", 1.0)
    code = CODES[name]
    ray, T = _cases(code, seed=2)
    skipped, bad = mk.filter_check(code, ray, T, EPS, MIN_Y, MAX_Y)
    assert bad > 0 and skipped > bad


def _filtered_nearest_hit(obj, meta, tables, o, d):
    """_nearest_hit's object loop with the kernel's filter: a plane's,
    sphere's or cylinder's test skipped (kBig) where the numpy copy shows
    it cannot give a t below the running winner's. Returns (t, winner)
    and the tests skipped."""
    group_bvh = {g: (r, e) for g, r, e in meta.group_bvh}
    oct_nodes = meta.n_nodes if meta.octant_orders else 0
    best_t = torch.full_like(o[0], BIG)
    w = torch.zeros(o[0].shape, dtype=torch.int64)
    active = torch.ones_like(o[0], dtype=torch.bool)
    skipped = 0
    for j, code in enumerate(meta.obj_types):
        m = obj[j]
        loc = (*mk._mat12_point(m, *o), *mk._mat12_vec(m, *d))
        if code == GROUP:
            pre = active & mk._group_pretest(m, EPS, *loc, best_t)
            t_j = mk.traverse_reference(
                *tables, meta.leaf_size, EPS, T_MAX, *group_bvh[j], *loc, pre,
                best_t, n_nodes=oct_nodes)[0]
        else:
            t_j = mk._object_t(code, m, EPS, *o, *d)
            if code != BOX:
                if code == PLANE:    # the kernel transforms its y row alone
                    oy, dy = mk._object_y(m, *o, *d)
                    loc = (loc[0], oy, loc[2], loc[3], dy, loc[5])
                with np.errstate(all="ignore"):
                    skip = object_skip(code, _np(best_t),
                                       *(_np(x) for x in loc))
                skipped += int(skip.sum())
                t_j = torch.where(torch.from_numpy(skip), BIG, t_j)
        closer = t_j < best_t
        best_t = torch.where(closer, t_j, best_t)
        w = torch.where(closer, j, w)
    return best_t, w, skipped


@pytest.mark.parametrize("scene", ["reference", "default"])
def test_filtered_loop_is_nearest_hit(scene):
    # camera rays and one random bounce from their hits, 16x12 pixels x 8
    cfg = RenderConfig(width=16, height=12)
    sc = get_scene(scene, cfg)
    arrays, meta = sc.pack(device="cpu")
    obj = torch.from_numpy(mk.build_scene_table(arrays, meta)).tolist()
    tables = [torch.from_numpy(t) for t in mk.build_mesh_tables(arrays, meta)]
    gen = torch.Generator().manual_seed(3)
    o, d = camera_rays(sc.camera, 16, 12, 8, gen)
    active = torch.ones_like(o[0], dtype=torch.bool)
    t = mk._nearest_hit(obj, meta, *tables, EPS, T_MAX, *o, *d, active,
                        0)[0]
    o2, d2 = bounce_rays(o, d, t, T_MAX, gen)
    tests = 0
    for ray in ((o, d), (o2, d2)):
        want_t, want_w = mk._nearest_hit(obj, meta, *tables, EPS, T_MAX,
                                         *ray[0], *ray[1], active, 0)[:2]
        got_t, got_w, skipped = _filtered_nearest_hit(obj, meta, tables,
                                                      *ray)
        assert torch.equal(got_t, want_t)
        assert torch.equal(got_w, want_w)
        tests += skipped
    # most primitive tests are skipped on these scenes
    n_prim = sum(c in (PLANE, SPHERE, CYLINDER) for c in meta.obj_types)
    assert tests > 0.3 * n_prim * 2 * o[0].numel()
