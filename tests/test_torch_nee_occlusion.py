"""K1-nee's shadow query (csrc/megakernel.cu light_visible; its plain
version megakernel._light_visible) against the nearest-hit rule that the
render keeps (megakernel._nearest_hit, the JAX kernel's formulation,
pallas_kernel.py:2452-2498): a cast shadow ray lights its point when
light l is the nearest hit with eps < t < t_max. The query tests the
light first, stops at the first occluder and walks a GROUP with an any-hit
exit; it must give the same flag on every ray and, where lit, the same
t_l (the attenuation's). Exact equality: both decide on the same f32 values.

The rays are the render's kind: shadow rays from the surface points of
camera rays and of one random bounce, toward a random point on each
light's sphere (randomPointOnSphere as the kernel draws it), plus the
cases that reach the rule's edges: ties with a copy of the light before
and after it, a plane tangent to the light, a light after a group, a
GROUP light, rays that miss the light, and t_l at eps and at t_max.
`test_render_counts_hold_the_rule` runs the plain render with its counts,
which puts every cast shadow ray through both and raises where they
differ. The CUDA kernel is held against the plain version bit for bit by
chip_smoke.py (phase 3, the tie scenes too) on a card.

The light point's sin and cos: the kernel takes one sincosf an angle, the
plain version torch.sin and torch.cos. The card check (chip_smoke.py phase
3, tests/test_torch_cuda.py) compares them on every f32 angle of the
light point's ranges; `test_sincos_check_sees_one_ulp` shows that check
fails a sincos one ulp off on a single angle.
"""
import math

import numpy as np
import pytest
import torch

from _torch_scenes import (LIGHT_ANGLE_BITS, bounce_rays, camera_rays,
                           port_inputs, sincos_mismatches, tie_scene)
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.geometry import transforms as gx
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scene.material import Material
from pathtracer_tpu_torch.scene.shapes import Plane
from pathtracer_tpu_torch.scenes import get_scene

torch.set_num_threads(2)

W, H, N = 16, 12, 4       # camera rays: W x H pixels, N a pixel
EPS, T_MAX = 1e-4, 1024.0


def _tables(sc):
    arrays, meta = sc.pack(device="cpu")
    obj = torch.from_numpy(mk.build_scene_table(arrays, meta))
    nodes, tris = (torch.from_numpy(t)
                   for t in mk.build_mesh_tables(arrays, meta))
    return obj.tolist(), meta, nodes, tris


def _points(sc, tabs, seed):
    """Surface points of camera rays and of one random bounce from them:
    (px, py, pz) and the mask of rays that hit."""
    obj, meta, nodes, tris = tabs
    gen = torch.Generator().manual_seed(seed)
    o, d = camera_rays(sc.camera, W, H, N, gen)
    t = mk._nearest_hit(obj, meta, nodes, tris, EPS, T_MAX, *o, *d,
                        torch.ones_like(o[0], dtype=torch.bool), 0)[0]
    o2, d2 = bounce_rays(o, d, t, T_MAX, gen)
    t2 = mk._nearest_hit(obj, meta, nodes, tris, EPS, T_MAX, *o2, *d2,
                         torch.ones_like(o[0], dtype=torch.bool), 0)[0]
    p = [torch.cat([a + b * torch.clamp(tt, max=T_MAX) for a, b, tt in
                    ((a, b, t), (a2, b2, t2))])
         for a, b, a2, b2 in zip(o, d, o2, d2)]
    return p, torch.cat([t < T_MAX, t2 < T_MAX])


def _toward_light(obj, l, p, seed):
    """Shadow rays from points p toward a random point on light l's
    sphere (the kernel's randomPointOnSphere, its latitude offset kept),
    their origin moved off the surface by EPS along the ray."""
    lm = obj[l]
    rng = np.random.default_rng(seed)
    nu1, nu2 = (torch.from_numpy(rng.random(p[0].numel(), np.float32))
                for _ in range(2))
    lat = mk._acos(2.0 * nu1 - 1.0) - 2.0 * math.pi
    lon = 2.0 * math.pi * nu2
    cl = torch.cos(lat)
    lp = (lm[40] + cl * torch.cos(lon) * lm[43],
          lm[41] + (torch.sin(lat) - math.pi * 0.25) * lm[43],
          lm[42] + cl * torch.sin(lon) * lm[43])
    sd = mk._normalize(*(a - b for a, b in zip(lp, p)))
    return (*(a + b * EPS for a, b in zip(p, sd)), *sd)


def _random_dirs(p, seed):
    """Rays from points p in uniformly random directions: most miss the
    light."""
    gen = torch.Generator().manual_seed(seed)
    d = torch.randn((3, p[0].numel()), generator=gen)
    d = d / torch.linalg.vector_norm(d, dim=0)
    return (*p, *d)


def _compare(tabs, ray, cast, l, eps=EPS, t_max=T_MAX):
    """The query against the nearest-hit rule on every ray: (lit, t_l,
    the nearest hit's t, counts)."""
    obj, meta, nodes, tris = tabs
    s_t, s_w, *_ = mk._nearest_hit(obj, meta, nodes, tris, eps, t_max, *ray,
                                   cast, -1)
    want = cast & (s_w == l) & (s_t > eps) & (s_t < t_max)
    counts = {k: 0 for k in mk.QUERY_COUNTS}
    got, t_l = mk._light_visible(obj, meta, nodes, tris, eps, t_max, *ray,
                                 cast, l, counts)
    assert torch.equal(got, want)
    assert torch.equal(t_l[want], s_t[want])
    # every cast ray is lit, occluded or misses its light
    assert (int(want.sum()) + counts["shadow_occluded"]
            + counts["shadow_light_missed"] == int(cast.sum()))
    return want, t_l, s_t, counts


def _tangent_plane_scene(cfg, before=False):
    """`reference` with a plane tangent to the flattened light's underside
    (y = 0.399 - 0.01), after the light in the table (before it when
    `before`)."""
    sc = get_scene("reference", cfg)
    plane = Plane()
    plane.set_transform(gx.translate(0.0, 0.389, 0.0))
    plane.set_material(Material.diffuse(0.5, 0.5, 0.5))
    sc.objects = ([plane] + sc.objects) if before else (sc.objects + [plane])
    return sc


def _group_light_scene(cfg):
    """`teapot` with its model group emissive: a GROUP light (index 6),
    after the walls."""
    sc = get_scene("teapot", cfg)
    sc.objects[6].material.emission = (2.0, 2.0, 2.0)
    return sc


def _scene(case):
    cfg = RenderConfig(width=W, height=H, nee=True)
    if case == "tie":
        return tie_scene(cfg, get_scene, "reference")
    if case == "tie mesh":
        return tie_scene(cfg, get_scene, "teapot")
    if case == "tangent plane":
        return _tangent_plane_scene(cfg)
    if case == "light after a group":
        return get_scene("default", cfg)     # group 9, light 10
    if case == "group light":
        return _group_light_scene(cfg)
    return get_scene(case, cfg)


SHADOW_CASES = ("reference", "teapot", "transparency_quad_lights", "tie",
                "tie mesh", "tangent plane", "light after a group",
                "group light")


@pytest.mark.parametrize("case", SHADOW_CASES)
def test_query_is_the_nearest_hit_rule(case):
    sc = _scene(case)
    tabs = _tables(sc)
    meta = tabs[1]
    p, hit = _points(sc, tabs, 1)
    lit = {}
    for li, l in enumerate(meta.light_indices):
        ray = _toward_light(tabs[0], l, p, 10 + li)
        lit[l] = int(_compare(tabs, ray, hit, l)[0].sum())
    assert sum(lit.values()) > 0
    if case.startswith("tie"):
        # A (the first light) ties with its copy after it and stays lit;
        # B ties with its copy before it and is never lit
        a, b = meta.light_indices
        assert lit[a] > 0 and lit[b] == 0
    if case == "light after a group":
        assert meta.obj_types.index(mk.GROUP) < meta.light_indices[0]
    if case == "group light":
        assert mk.GROUP in (meta.obj_types[l] for l in meta.light_indices)


@pytest.mark.parametrize("before", (False, True))
def test_query_at_the_tangent_point(before):
    # rays straight up at the tangent point of the plane and the light's
    # underside, and just around it: most meet the plane at the light's t
    # to the bit, which the plane after the light leaves lit (`<`) and the
    # plane before it occludes (`<=`)
    sc = _tangent_plane_scene(RenderConfig(width=W, height=H, nee=True),
                              before)
    tabs = _tables(sc)
    l, = tabs[1].light_indices
    n = 257
    off = torch.linspace(-1e-3, 1e-3, n)
    ray = (off, torch.full((n,), -0.3), torch.zeros(n),
           torch.zeros(n), torch.ones(n), torch.zeros(n))
    lit, t_l, _, _ = _compare(tabs, ray, torch.ones(n, dtype=torch.bool), l)
    m = tabs[0][0 if before else len(tabs[0]) - 1]
    t_plane = mk._plane_t(mk._mat12_point(m, *ray[:3])[1],
                          mk._mat12_vec(m, *ray[3:])[1], EPS)
    tie = t_plane == t_l
    assert tie.any()
    assert torch.equal(lit, torch.zeros_like(tie) if before else tie)


def test_query_rays_that_miss_the_light():
    sc = get_scene("teapot", RenderConfig(width=W, height=H, nee=True))
    tabs = _tables(sc)
    p, hit = _points(sc, tabs, 2)
    _, _, _, counts = _compare(tabs, _random_dirs(p, 3), hit, 0)
    # most random rays miss the light: the query ends after its test
    assert counts["shadow_light_missed"] > int(hit.sum()) // 2


@pytest.mark.parametrize("edge", ("eps", "t_max"))
def test_query_with_t_l_at_the_bounds(edge):
    # eps (or t_max) set to the light's t of some lit rays: a t on the
    # strict bound is never a lit ray's t_l by either rule (at eps the
    # sphere's far side may light it); one float inside the bound lights
    # them again at the same t_l
    sc = get_scene("reference", RenderConfig(width=W, height=H, nee=True))
    tabs = _tables(sc)
    p, hit = _points(sc, tabs, 4)
    ray = _toward_light(tabs[0], 0, p, 5)
    lit, t_l, _, _ = _compare(tabs, ray, hit, 0)
    bound = float(torch.median(t_l[lit]))
    on = lit & (t_l == bound)
    assert on.any()
    lit_b, t_b, _, _ = _compare(tabs, ray, hit, 0, **{edge: bound})
    assert not (lit_b & (t_b == bound)).any()
    inside = float(np.nextafter(np.float32(bound), np.float32(
        0.0 if edge == "eps" else np.inf)))
    lit2, t_l2, _, _ = _compare(tabs, ray, hit, 0, **{edge: inside})
    assert torch.equal(lit2 & on, on)
    assert torch.equal(t_l2[on], t_l[on])


RENDER_CASES = (("tie", (8, 128)), ("tie mesh", (8, 512)),
                ("light after a group", (8, 512)),
                ("transparency_quad_lights", (8, 128)))


@pytest.mark.parametrize("case,tile", RENDER_CASES)
def test_render_counts_hold_the_rule(case, tile):
    # trace_tiles_reference with counts puts every cast shadow ray through
    # the query and raises where it differs from the nearest-hit rule
    sc = _scene(case)
    cfg = RenderConfig(width=W, height=H, samples=2, samples_per_pass=2,
                       nee=True)
    tabs, meta, _, lay = port_inputs(sc, cfg, tile, torch.device("cpu"))
    counts = {}
    mk.trace_tiles_reference((1, 0), *tabs, meta=meta, cfg=cfg, spp=2,
                             total_samples=2, tile=tile, counts=counts,
                             **lay)
    assert counts["shadow_tests"] > 0
    assert (counts["shadow_lit"] + counts["shadow_occluded"]
            + counts["shadow_light_missed"] == counts["shadow_tests"])
    if meta.has_groups:
        # the any-hit walks visit no more than the nearest-hit walks
        assert 0 < counts["query_nodes"] <= counts["shadow_nodes"]
        assert counts["query_slots"] <= counts["shadow_slots"]


@pytest.mark.parametrize("off", ("none", "sin", "cos"))
def test_sincos_check_sees_one_ulp(off):
    # the first and last 3000 angles of each range, through the plain
    # light_sincos, with one value of one angle moved by an ulp
    ranges = [r for lo, hi in LIGHT_ANGLE_BITS
              for r in ((lo, lo + 2999), (hi - 2999, hi))]
    seen = []

    def sincos(x):
        s, c = mk.light_sincos(x)
        if off != "none" and not seen:
            v = s if off == "sin" else c
            v[7] = torch.nextafter(v[7], torch.tensor(2.0))
        seen.append(x.numel())
        return s, c

    n, bad = sincos_mismatches(sincos, "cpu", ranges, chunk=1000)
    assert n == sum(seen) == 12000
    assert bad == (0 if off == "none" else 1)
