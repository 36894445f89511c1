"""Scenes and tolerances shared by the pathtracer_tpu_torch tests. Imports
no jax, so the tests that need a CUDA card can run where jax is absent."""
from __future__ import annotations

import contextlib
import math
import os
import tempfile
from unittest import mock

import numpy as np
import torch

from pathtracer_tpu_torch.assets import uv_sphere_obj
from pathtracer_tpu_torch.render import integrator
from pathtracer_tpu_torch.render import megakernel as mk

# the primitive, untextured scenes of the port
SLICE_SCENES = ("reference", "reflection", "transparency",
                "transparency_quad_lights", "transparency_f_light")
# the untextured mesh scenes (teapot and gopher load a 1472-triangle UV
# sphere in place of their .obj, glass a 576-triangle goblet)
MESH_SCENES = ("default", "teapot", "christian", "transparent_teapot",
               "glass", "gopher", "gopher-window")
# the textured scenes: procedural textures (`textures` with normal maps,
# the `envmap` sky sphere, the `cubemap` sky cube around the gopher
# stand-in) and the file-texture extensions (plain arrays: the JAX package
# stages them, `envmap-file` as a 128x128 mip)
TEX_SCENES = ("textures", "envmap", "cubemap", "textures-file",
              "textures-train", "envmap-file")
# the size-check mesh: a UV sphere of exactly as many triangles as the
# reference's gopher.obj (16640; 8319 nodes at the port's BVH leaf 4, 2079
# at the JAX package's 16)
SIZE_CHECK_LAT_LON = (66, 128)

# per-slot rule: f32 round-off, with room for a few paths that diverge on
# a one-ulp difference in cos/sin at a roulette threshold
ATOL, RTOL = 1e-4, 1e-3
SLOT_FRAC = 0.99
MEAN_REL = 0.01
# textured scenes against the JAX kernel: a slot value may also be off by
# up to TEXEL_STEPS, two texel steps of a directly seen texel (XLA:CPU
# contracts the JAX kernel's multiply-adds into FMAs, which moves a
# computed texel across an rgb8 rounding edge now and then;
# tests/test_torch_tex_kernel.py)
TEXEL_STEPS = 2.5 / 255

# gradient rule: gcol and gemi within GRAD_REL * max|g| on primitive scenes
# and GRAD_REL_MESH * max|g| on mesh scenes (exact-t ties may differ);
# >= SLOT_FRAC of the triangle slots within GRAD_REL_MESH * max|gtri|
GRAD_REL, GRAD_REL_MESH = 1e-4, 1e-3


def cylinder_scene(cfg, gx, mat, shapes, pack, cornell):
    left, right, floor, ceil, back, _front = cornell.cornell_walls()
    cyl = shapes.Cylinder(min_y=0.0, max_y=0.4, closed=True)
    cyl.set_transform(gx.translate(0.2, -0.4, -0.1))
    cyl.set_transform(gx.scale(0.12, 1, 0.12))
    cyl.set_material(mat.Material.diffuse(0.92, 0.4, 0.8))
    cube = shapes.Cube()
    cube.set_transform(gx.translate(-0.25, -0.3, -0.2))
    cube.set_transform(gx.scale(0.1, 0.1, 0.1))
    cube.set_transform(gx.rotate_y(math.pi / 5))
    cube.set_material(mat.Material.glass())
    light = shapes.Sphere()
    light.set_transform(gx.translate(0, 0.399, 0))
    light.set_transform(gx.scale(0.283, 0.01, 0.283))
    m = mat.Material.light_bulb()
    m.emission = (9.0, 9.0, 9.0)
    light.set_material(m)
    return pack.Scene(camera=cornell.default_camera(cfg),
                      objects=[light, floor, ceil, left, right, back, cyl,
                               cube])



def tie_scene(cfg, get_scene, base: str = "reference"):
    """Scene `base` (the port's; `get_scene` its registry) with its light
    replaced by two flattened sphere lights under the ceiling, each with a
    non-emissive copy of itself: A's copy just after A in the object
    table, B's just before B, both at the end of the table (after the
    walls, spheres and, for `teapot`, the model group). A copy's t equals
    its light's bit for bit, so every shadow ray toward A ties with A's
    copy after it (`<`: A stays the winner) and every one toward B ties
    with B's copy before it (`<=`: B never wins): the nearest-hit rule's
    two tie cases."""
    from pathtracer_tpu_torch.geometry import transforms as gx
    from pathtracer_tpu_torch.scene.material import Material
    from pathtracer_tpu_torch.scene.shapes import Sphere

    sc = get_scene(base, cfg)

    def flat_sphere(x, material):
        s = Sphere()
        s.set_transform(gx.translate(x, 0.399, 0.0))
        s.set_transform(gx.scale(0.2, 0.01, 0.2))
        s.set_material(material)
        return s

    light = Material.light_bulb()
    light.emission = (9.0, 9.0, 9.0)
    cover = Material.diffuse(0.9, 0.8, 0.7)
    sc.objects = sc.objects[1:] + [
        flat_sphere(-0.25, light), flat_sphere(-0.25, cover),
        flat_sphere(0.25, cover), flat_sphere(0.25, light)]
    return sc


# K1-nee's light point takes the sin and cos of its latitude acos(2u - 1) -
# 2 pi, in [-2 pi, -pi], and its longitude 2 pi u, in [0, 2 pi). As f32 bit
# patterns read as int32 (both ends included), a little more: the
# latitudes -3 .. -2 pi (sign bit set, so negative and rising with the
# magnitude) and the longitudes 0 .. 2 pi.
TWO_PI_BITS = 0x40C90FDB      # f32 of 2 pi
LIGHT_ANGLE_BITS = ((0xC0400000 - (1 << 32), (0x80000000 | TWO_PI_BITS)
                     - (1 << 32)),
                    (0, TWO_PI_BITS))


def sincos_mismatches(sincos, device, ranges=LIGHT_ANGLE_BITS,
                      chunk: int = 1 << 26) -> tuple:
    """(angles checked, angles whose sin or cos differ in any bit) of
    `sincos` (megakernel.light_sincos) against torch.sin and torch.cos on
    every f32 of the bit ranges `ranges`, `chunk` angles a call."""
    n = bad = 0
    for lo, hi in ranges:
        for a in range(lo, hi + 1, chunk):
            x = torch.arange(a, min(a + chunk, hi + 1), dtype=torch.int32,
                             device=device).view(torch.float32)
            s, c = sincos(x)
            bad += int(((s.view(torch.int32) != torch.sin(x).view(torch.int32))
                        | (c.view(torch.int32)
                           != torch.cos(x).view(torch.int32))).sum())
            n += x.numel()
    return n, bad


# the object loop's filter check (megakernel.filter_check): the values a
# case's components are drawn from in its special-value mode
FILTER_SPECIALS = (0.0, -0.0, 2.0 ** -149, -(2.0 ** -149), 2.0 ** -126,
                   1e-30, 3.4028235e38, -3.4028235e38, math.inf, -math.inf,
                   math.nan, 1.0, -1.0)
FILTER_MODES = 8


def filter_cases(code: int, n: int, seed: int, device, eps: float = 1e-4,
                 min_y: float = 0.0, max_y: float = 0.4):
    """n seeded cases of object type `code` (PLANE, SPHERE or CYLINDER, the
    cylinder's y range min_y, max_y) for megakernel.filter_check: (ray f32
    [6, n], object-space o xyz and d xyz; thresholds f32 [n] in (eps,
    1e30]). An eighth each: random rays and thresholds; grazing lines (the
    unit sphere's or the cylinder's side at 1 +- a few ulps; a plane's dy
    within ulps of +-eps); thresholds within 4 ulps of the exact t (half
    of the lines through the center or the axis); a root within ulps of
    eps; dy (a plane's) or |d_xz|^2 (a cylinder's) at eps and |d|^2 around
    the filter's 2^-40 (a sphere's); components drawn from zeros,
    subnormals, the extremes, inf and NaN; scales over 2^+-60; and the
    light query's threshold, 1e30."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f32 = torch.float32

    def U(*shape):
        return torch.rand(shape, generator=g, device=device, dtype=f32)

    def N(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=f32)

    def K(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             device=device).to(f32)

    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=0)

    big = 1e30
    mode = torch.randint(0, FILTER_MODES, (n,), generator=g, device=device)
    v = unit(N(3, n))                          # unit directions
    # points on the surface, and a unit vector across the line's direction
    if code == mk.PLANE:
        surf = torch.stack([N(n), torch.zeros(n, device=device), N(n)])
    elif code == mk.SPHERE:
        surf = unit(N(3, n))
    else:
        phi = U(n) * 6.2831855
        surf = torch.stack([torch.cos(phi),
                            min_y + (max_y - min_y) * U(n), torch.sin(phi)])
    # mode 0: random rays, thresholds over eps .. eps 2^34
    o0 = N(3, n) * torch.exp2(U(n) * 8 - 3)
    d0 = v * torch.exp2(U(n) * 8 - 4)
    T0 = eps * torch.exp2(U(n) * 34)
    # mode 1: grazing lines
    ulps = 1.0 + K(-64, 65, n) * 2.0 ** -23
    s = U(n) * 8 - 4
    if code == mk.SPHERE:
        w = unit(torch.linalg.cross(v, N(3, n), dim=0))
        o1 = w * ulps - v * s
    elif code == mk.CYLINDER:
        vxz = torch.stack([v[0], torch.zeros_like(v[0]), v[2]])
        vxz = unit(vxz)
        w = torch.stack([-vxz[2], torch.zeros_like(v[0]), vxz[0]])
        o1 = w * ulps - v * s
        o1[1] = surf[1] - v[1] * s
    else:
        o1 = o0.clone()
    d1 = v * torch.exp2(U(n) * 4 - 2)
    if code == mk.PLANE:
        d1[1] = torch.where(U(n) < 0.5, -eps, eps) * (
            1.0 + K(-8, 9, n) * 2.0 ** -23)
    # mode 2: aimed rays (half of them through the center or the axis,
    # where the nearer root is the farthest from the line's midpoint),
    # thresholds within 4 ulps of the exact t
    o2 = unit(N(3, n)) * (2 + U(n) * 2)
    aim = torch.where(U(n) < 0.5, 0.5 + U(n), 2.0 ** -20 * U(n))
    d2 = unit(surf * aim - o2) * torch.exp2(U(n) * 4 - 2)
    # mode 3: a root within a few ulps of eps
    d3 = v * torch.exp2(U(n) * 4 - 2)
    o3 = surf - d3 * (eps * (1.0 + K(-16, 17, n) * 2.0 ** -22))
    # mode 4: a plane's dy, a cylinder's |d_xz|^2 at eps; a sphere's |d|^2
    # across 2^-40
    o4 = o0.clone()
    d4 = v.clone()
    at_eps = 1.0 + K(-8, 9, n) * 2.0 ** -22
    if code == mk.PLANE:
        d4[1] = torch.where(v[1] < 0, -eps, eps) * at_eps
    elif code == mk.CYLINDER:
        r = torch.sqrt(v[0] * v[0] + v[2] * v[2])
        d4[0] = v[0] / r * math.sqrt(eps) * torch.sqrt(at_eps)
        d4[2] = v[2] / r * math.sqrt(eps) * torch.sqrt(at_eps)
    else:
        d4 = v * torch.exp2(U(n) * 30 - 35)
    # mode 5: components from the special values
    spec = torch.tensor(FILTER_SPECIALS, dtype=f32, device=device)
    pick = spec[torch.randint(0, len(FILTER_SPECIALS), (6, n), generator=g,
                              device=device)]
    o5, d5 = (torch.where(U(3, n) < 0.3, pick[k:k + 3], x)
              for k, x in ((0, o0), (3, d0)))
    # mode 6: scales over 2^+-60, thresholds over 2^-13 .. 2^87
    o6 = N(3, n) * torch.exp2(U(n) * 120 - 60)
    d6 = v * torch.exp2(U(n) * 80 - 40)
    T6 = torch.exp2(U(n) * 100 - 13)

    def pick_mode(*xs):
        out = xs[0]
        for m, x in enumerate(xs[1:], 1):
            out = torch.where(mode == m, x, out)
        return out

    o = pick_mode(o0, o1, o2, o3, o4, o5, o6, o2)
    d = pick_mode(d0, d1, d2, d3, d4, d5, d6, d2)
    # the exact t of each ray, for mode 2's thresholds
    if code == mk.PLANE:
        t = mk._plane_t(o[1], d[1], eps)
    elif code == mk.SPHERE:
        t = mk._sphere_t(*o, *d, eps)
    else:
        t = mk._cylinder_t(*o, *d, min_y, max_y, eps)
    near = (t.view(torch.int32) + torch.randint(
        -4, 5, (n,), generator=g, device=device, dtype=torch.int32)
        ).view(f32)
    T2 = torch.where((t > eps) & (t < big), near, T0)
    T = pick_mode(T0, T0, T2, T0, T0, T0, T6, torch.full_like(T0, big))
    T = torch.minimum(torch.where(T > eps, T, torch.nextafter(
        torch.tensor(eps, dtype=f32, device=device),
        torch.tensor(big, dtype=f32, device=device)).expand(n)),
        torch.tensor(big, dtype=f32, device=device))
    return torch.cat([o, d]).contiguous(), T.contiguous()


def textured_teapot(sc, make):
    """The `teapot` scene `sc` (either package's) cut to its light, floor,
    model and sphere, the floor and the sphere textured by small file
    checkers (`make`: that package's render.proctex.make), which both
    packages stage: a mesh scene with staged textures, the one that reaches
    the mesh instantiation of the texel-gradient kernel (`<true, true,
    true, true>`)."""
    light, floor, _, _, _, _, model, sphere = sc.objects
    sc.objects = [light, floor, model, sphere]
    for o in (floor, sphere):
        o.material.textured = True
        o.material.texture_id = 0
    sc.textures = [np.asarray(make(
        ("checker", (8, (0.9, 0.6, 0.3), (0.2, 0.3, 0.6))), 64, 64)).copy()]
    sc.sphere_textures = [np.asarray(make(
        ("checker", (8, (0.8, 0.8, 0.2), (0.2, 0.7, 0.7))), 64, 128)).copy()]
    return sc


def size_check_scene(cfg, get_scene, lat_lon=SIZE_CHECK_LAT_LON):
    """The `teapot` scene with its model replaced by the 16640-triangle
    size-check UV sphere (or the UV sphere of `lat_lon`), loaded through
    the scene's own model loader (`get_scene` is either package's): the
    .obj is written to a temporary asset directory named by PT_ASSETS for
    the duration of the call."""
    old = os.environ.get("PT_ASSETS")
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "teapot.obj"), "w") as f:
            f.write(uv_sphere_obj(*lat_lon, name="teapot"))
        os.environ["PT_ASSETS"] = d
        try:
            return get_scene("teapot", cfg)
        finally:
            if old is None:
                del os.environ["PT_ASSETS"]
            else:
                os.environ["PT_ASSETS"] = old


def camera_rays(camera, W: int, H: int, n: int, gen):
    """n jittered camera rays a pixel (rayForPixel without depth of field)
    on the device of the torch.Generator `gen`: (origin, direction)
    3-tuples of contiguous f32 [W*H*n]."""
    dev = gen.device
    c = torch.from_numpy(mk.build_camera_vec(camera)).to(dev)
    i = torch.arange(W * H * n, device=dev) // n
    x, y = (i % W).to(torch.float32), (i // W).to(torch.float32)
    jx, jy = (torch.rand(W * H * n, generator=gen, device=dev)
              for _ in range(2))
    vx = c[13] - c[12] * (x + jx)
    vy = c[14] - c[12] * (y + jy)
    m = c[:12].reshape(3, 4)
    d = torch.stack([m[k, 0] * vx + m[k, 1] * vy - m[k, 2] for k in
                     range(3)])
    d = d / torch.linalg.vector_norm(d, dim=0)
    o = m[:, 3:4].expand(3, W * H * n)
    return (tuple(a.contiguous() for a in o),
            tuple(a.contiguous() for a in d))


def bounce_rays(origin, direction, t, t_max: float, gen):
    """One bounce of random rays: from each hit point (t < t_max), backed
    off along the incoming ray by 1e-3, in a uniformly random direction on
    the incoming ray's side (a miss keeps its origin). Returns (origin,
    direction) as camera_rays."""
    hit = t < t_max
    o = [torch.where(hit, a + b * (t - 1e-3), a)
         for a, b in zip(origin, direction)]
    d = torch.randn((3, t.numel()), generator=gen, device=t.device)
    d = d / torch.linalg.vector_norm(d, dim=0)
    d = torch.where((d * torch.stack(direction)).sum(0) > 0.0, -d, d)
    return tuple(a.contiguous() for a in o), tuple(a.contiguous() for a in d)


def assert_slot_rule(port: np.ndarray, ref: np.ndarray) -> None:
    """>= SLOT_FRAC of values within ATOL/RTOL, each channel mean within
    MEAN_REL. Arrays are [3, ...]."""
    assert port.shape == ref.shape
    assert np.isfinite(port).all()
    frac = np.isclose(port, ref, atol=ATOL, rtol=RTOL).mean()
    assert frac >= SLOT_FRAC, frac
    pm = port.reshape(3, -1).mean(1)
    rm = ref.reshape(3, -1).mean(1)
    np.testing.assert_array_less(np.abs(pm - rm) / np.abs(rm), MEAN_REL)


def assert_tex_slot_rule(port: np.ndarray, ref: np.ndarray) -> None:
    """assert_slot_rule with the textured allowance: >= SLOT_FRAC of values
    within ATOL/RTOL or within TEXEL_STEPS, each channel mean within
    MEAN_REL. Arrays are [3, ...]."""
    assert port.shape == ref.shape
    assert np.isfinite(port).all()
    near = (np.isclose(port, ref, atol=ATOL, rtol=RTOL)
            | (np.abs(port - ref) <= TEXEL_STEPS))
    assert near.mean() >= SLOT_FRAC, near.mean()
    pm = port.reshape(3, -1).mean(1)
    rm = ref.reshape(3, -1).mean(1)
    np.testing.assert_array_less(np.abs(pm - rm) / np.abs(rm), MEAN_REL)


def port_inputs(sc, cfg, tile, device, packed=None):
    """The megakernel's inputs for scene `sc` on `device`, built as the
    driver builds them: the scene's default tile order and sample packing
    for cfg.samples, on `tile` (None: the scene's default tile), from
    `packed` (sc.pack's (arrays, meta) on `device`) when given. Returns
    ([cam, obj, nodes, tris, px, py], meta, pid, {"spp_pack": ...,
    "pack_axis": ...}), the dict with the texel pool and texture table too
    (tex_pool, tex_table) for a textured scene."""
    arrays, meta = packed or sc.pack(device=device)
    tile = tile or mk.default_tile(meta)
    axis = mk.default_pack_axis(meta)
    pack = mk.clamp_pack(mk.default_pack(meta, cfg.samples), *tile, axis)
    xs, ys, pid = mk.tile_pixel_layout(cfg.width, cfg.height, *tile,
                                       order=mk.default_order(meta),
                                       spp_pack=pack, pack_axis=axis)
    tabs = [torch.from_numpy(t).to(device) for t in (
        mk.build_camera_vec(sc.camera), mk.build_scene_table(arrays, meta),
        *mk.build_mesh_tables(arrays, meta), xs, ys)]
    return tabs, meta, pid, {"spp_pack": pack, "pack_axis": axis,
                             **mk.texture_inputs(arrays, meta, device)}


def grad_inputs(sc, cfg, tile, device):
    """The gradient kernel's inputs for scene `sc` on `device`, laid out as
    the training steps lay them out: the scene's default tile order, no
    sample packing. Returns ([cam, obj, nodes, tris, px, py], meta,
    arrays, pid)."""
    arrays, meta = sc.pack(device=device)
    xs, ys, pid = mk.tile_pixel_layout(cfg.width, cfg.height, *tile,
                                       order=mk.default_order(meta))
    tabs = [torch.from_numpy(t).to(device) for t in (
        mk.build_camera_vec(sc.camera), mk.build_scene_table(arrays, meta),
        *mk.build_mesh_tables(arrays, meta), xs, ys)]
    return tabs, meta, arrays, pid


def grad_rule(got, want, mesh: bool) -> dict:
    """Hold grad_tiles' results (gcol, gemi[, gtri]) against another run's
    by the gradient rule; raises AssertionError. Returns the relative
    errors {"gcol", "gemi"} and, with gtri, the fraction of triangle slots
    within the rule ("gtri_frac") and the max abs error over them."""
    rel = GRAD_REL_MESH if mesh else GRAD_REL
    got = [g.detach().cpu().numpy() for g in got]
    want = [w.detach().cpu().numpy() for w in want]
    out = {}
    for what, g, w in zip(("gcol", "gemi"), got, want):
        if g.shape != w.shape or not np.isfinite(g).all():
            raise AssertionError(f"{what}: shape {g.shape} vs {w.shape}, "
                                 "or not finite")
        out[what] = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
        if out[what] >= rel:
            raise AssertionError(f"{what}: max rel err {out[what]:.2e} "
                                 f"(need < {rel})")
    out["max_abs_err"] = float(max(np.abs(g - w).max()
                                   for g, w in zip(got, want)))
    if len(got) == 3:
        g, w = got[2], want[2]
        if g.shape != w.shape or not np.isfinite(g).all():
            raise AssertionError("gtri: shape or finiteness")
        close = (np.abs(g - w) <= rel * np.abs(w).max()).all(axis=1)
        out["gtri_frac"] = float(close.mean())
        out["gtri_slots_hit"] = int((np.abs(w) > 0).any(axis=1).sum())
        out["max_abs_err"] = max(out["max_abs_err"],
                                 float(np.abs(g - w).max()))
        if out["gtri_frac"] < SLOT_FRAC or out["gtri_slots_hit"] == 0:
            raise AssertionError(f"gtri: {out['gtri_frac']:.4f} of slots "
                                 f"within the rule (need {SLOT_FRAC}), "
                                 f"{out['gtri_slots_hit']} slots hit")
    return out


def ablated_grad_rule(got, want) -> dict:
    """grad_rule for a replay without leaf tests (PT_ABLATE_LEAF=1: no
    triangle is ever hit): the triangle gradients (got[2], want[2]) exactly
    zero on both sides, gcol and gemi by the mesh rule; raises
    AssertionError. Returns grad_rule's numbers of gcol and gemi."""
    for what, g in (("got", got[2]), ("want", want[2])):
        if torch.as_tensor(g).any():
            raise AssertionError(f"gtri of {what}: nonzero without leaf "
                                 "tests")
    return grad_rule(got[:2], want[:2], mesh=True)


# texel gradient rule: >= SLOT_FRAC of the texels that either side touches
# within GRAD_REL_MESH * max|gtex|, each channel's sum within TEX_SUM_REL
TEX_SUM_REL = 0.01


def tex_grad_rule(got, want) -> dict:
    """Hold grad_tiles(tex_grads=True)'s (gcol, gemi, gtex) against another
    run's: gcol and gemi within GRAD_REL_MESH * max|g|, gtex [T, 3] by the
    texel rule; raises AssertionError. Returns the relative errors, the
    share of touched texels within the rule ("gtex_frac"), the touched
    count, the largest channel-sum error and the max abs error."""
    out = grad_rule(got[:2], want[:2], mesh=True)
    g, w = (a.detach().cpu().double().numpy() for a in (got[2], want[2]))
    if g.shape != w.shape or not np.isfinite(g).all():
        raise AssertionError("gtex: shape or finiteness")
    touched = (g != 0) | (w != 0)
    close = np.abs(g - w) <= GRAD_REL_MESH * np.abs(w).max()
    out["gtex_touched"] = int(touched.any(axis=1).sum())
    out["gtex_frac"] = float(close[touched].mean()) if touched.any() else 0.0
    out["gtex_sum_rel"] = float(np.max(np.abs(g.sum(0) - w.sum(0))
                                       / np.abs(w.sum(0))))
    out["max_abs_err"] = max(out["max_abs_err"], float(np.abs(g - w).max()))
    if (out["gtex_frac"] < SLOT_FRAC or out["gtex_sum_rel"] >= TEX_SUM_REL
            or not out["gtex_touched"]):
        raise AssertionError(
            f"gtex: {out['gtex_frac']:.4f} of {out['gtex_touched']} touched "
            f"texels within the rule (need {SLOT_FRAC}), channel sums off by "
            f"{out['gtex_sum_rel']:.2e} (need < {TEX_SUM_REL})")
    return out



def one_warp_live(tabs, kw, block: int = 128, warp: int = 32):
    """The megakernel inputs `tabs` (port_inputs' list, px and py last) with
    every slot past the first warp of each `block`-slot thread block moved
    onto one pixel whose camera rays hit a light: those paths end at their
    first hit, so in each block one warp stays live after the others
    (the packet walks' dead warps). The pixel is the lit pixel nearest the
    lit area's center whose 8 neighbours are lit too (a 1-bounce plain
    render on the inputs), so that jitter keeps its rays on the light.
    Returns (the new tabs, the pixel)."""
    import dataclasses
    px, py = tabs[-2], tabs[-1]
    once = dict(kw, cfg=dataclasses.replace(kw["cfg"], max_bounces=1))
    out = mk.trace_tiles_reference((1, 0), *tabs, **once)[0].reshape(-1)
    lit = {(int(x), int(y)) for x, y, v in zip(px.reshape(-1).tolist(),
                                              py.reshape(-1).tolist(),
                                              out.tolist()) if v > 0}
    inner = [q for q in lit if all((q[0] + i, q[1] + j) in lit
                                   for i in (-1, 0, 1) for j in (-1, 0, 1))]
    if not inner:
        raise ValueError("no pixel of the inputs sees a light")
    cx = sum(q[0] for q in inner) / len(inner)
    cy = sum(q[1] for q in inner) / len(inner)
    pixel = min(inner, key=lambda q: ((q[0] - cx) ** 2 + (q[1] - cy) ** 2,
                                      q))
    late = (torch.arange(px.numel(), device=px.device) % block
            >= warp).reshape(px.shape)
    qx, qy = px.clone(), py.clone()
    qx[late], qy[late] = pixel
    return [*tabs[:-2], qx, qy], pixel


@contextlib.contextmanager
def at_backward(read):
    """Yields a list that gets read() each time torch.autograd.grad (the
    backward of diff.loss_and_grads) starts: what a counter had reached
    by the end of the forward, the rest being the backward's."""
    seen = []
    real = torch.autograd.grad

    def grad(*a, **kw):
        seen.append(read())
        return real(*a, **kw)
    with mock.patch.object(torch.autograd, "grad", grad):
        yield seen


def free_for(n_plain: int, n_rays: int) -> int:
    """Free bytes under which integrator._plain_bounces keeps the first
    n_plain bounces of n_rays rays plain (fewer than max_bounces) on a
    scene it may rematerialize."""
    return (n_plain + 1) * n_rays * integrator._BOUNCE_BYTES * 4 // 3 + 3


def free_bytes(n: int):
    """integrator._free_bytes patched to n on every device: 0
    rematerializes every bounce of a textured scene's differentiated
    fixed trip, a huge n none."""
    return mock.patch.object(integrator, "_free_bytes", lambda dev: n)
