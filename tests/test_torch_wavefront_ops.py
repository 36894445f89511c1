"""The wavefront's modules (pathtracer_tpu_torch.render: vec3, sampling,
uv, camera, intersect and the integrator's shading helpers) against the
JAX package's functions, op by op on the same numpy-seeded inputs, in f32
and f64 on the CPU. The JAX side runs eagerly (jax.disable_jit), so XLA
fuses no multiply-add the port does not do.

Tolerances: continuous outputs within TOL[dtype] (f32: 4e-6 relative plus
1e-6 absolute, a few ulps: the transcendental functions and torch's CPU
sqrt differ from XLA's by ulps; f64: 1e-12; texture colors TEX_TOL, f32
atol 2e-5, since a UV some ulps off moves the bilinear weights of a
2048-texel side); integer and boolean outputs
equal, but for the intersections, where a one-ulp t can flip a near tie
or an edge: there the winning object, triangle slot and hit flag agree on
all but DISCRETE_FRAC of the rays, and t, u, v on the agreeing rays
within JIT_TOL (f32: 2e-5 relative plus 1e-5 absolute; the JAX walk runs
under jit there, where XLA fuses multiply-adds).
The intersect kernel's route (megakernel.intersect_batch's plain version)
agrees with the torch walk on the object of every ray but the counted
exact ties.
"""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu.native as jnative
from _torch_parity import jax_pack, scene_pair
from pathtracer_tpu.config import RenderConfig as JaxConfig
from pathtracer_tpu.render import camera as jcam
from pathtracer_tpu.render import integrator as jit_
from pathtracer_tpu.render import intersect as jint
from pathtracer_tpu.render import sampling as jsam
from pathtracer_tpu.render import uv as juv
from pathtracer_tpu.render import vec3 as jv
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.render import camera as tcam
from pathtracer_tpu_torch.render import integrator as tit
from pathtracer_tpu_torch.render import intersect as tint
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.render import sampling as tsam
from pathtracer_tpu_torch.render import uv as tuv
from pathtracer_tpu_torch.render import vec3 as tv

torch.set_num_threads(2)

CPU = torch.device("cpu")
DTYPES = ("float32", "float64")
TOL = {"float32": dict(rtol=4e-6, atol=1e-6),
       "float64": dict(rtol=1e-12, atol=1e-12)}
# texture colors: a UV a few ulps off (arctan2, arccos), times a side of
# up to 2048 texels, moves the bilinear weights by ~1e-4 of a texel step
TEX_TOL = {"float32": dict(rtol=4e-6, atol=2e-5), "float64": TOL["float64"]}
# the jitted JAX walk: XLA fuses multiply-adds, each rounding once less
JIT_TOL = {"float32": dict(rtol=2e-5, atol=1e-5), "float64": TOL["float64"]}
DISCRETE_FRAC = 5e-4
R = 4096


@contextlib.contextmanager
def jax_dtype(dt, eager=True):
    """JAX with x64 on for f64 (restored after), eager unless not
    `eager`."""
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dt == "float64")
    try:
        with jax.disable_jit() if eager else contextlib.nullcontext():
            yield
    finally:
        jax.config.update("jax_enable_x64", x64)


def rng(k=0):
    return np.random.default_rng(k)


def both(a, dt):
    """numpy a as (jnp array, torch tensor) of dtype dt (floats)."""
    a = np.asarray(a, dtype=dt)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def vec(a, dt):
    """[3, R] numpy as (JAX Vec3, torch Vec3)."""
    j, t = zip(*(both(c, dt) for c in a))
    return jv.Vec3(*j), tv.Vec3(*t)


def close(got, want, dt, msg="", tol=TOL):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            close(g, w, dt, msg, tol)
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, msg
    if got.dtype.kind in "biu":
        assert np.array_equal(got, want), msg
        return
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, err_msg=msg, **tol[dt])


def unit(k, n=R):
    d = rng(k).normal(size=(3, n))
    return d / np.linalg.norm(d, axis=0)


@pytest.mark.parametrize("dt", DTYPES)
def test_vec3_ops(dt):
    with jax_dtype(dt):
        (ja, ta), (jb, tb) = vec(rng(1).normal(size=(3, R)), dt), vec(
            rng(2).normal(size=(3, R)), dt)
        js, ts = both(rng(3).normal(size=R), dt)
        for name, f in (
                ("add", lambda a, b, s: a + b), ("sub", lambda a, b, s: a - b),
                ("neg", lambda a, b, s: -a), ("had", lambda a, b, s: a * b),
                ("scale", lambda a, b, s: a * s), ("rscale", lambda a, b, s:
                                                   2.0 * a),
                ("dot", lambda a, b, s: a.dot(b)),
                ("cross", lambda a, b, s: a.cross(b)),
                ("norm", lambda a, b, s: a.norm()),
                ("normalized", lambda a, b, s: a.normalized()),
                ("reflect", lambda a, b, s: a.reflect(b.normalized())),
                ("abs", lambda a, b, s: a.abs()),
                ("max", lambda a, b, s: a.max_component()),
                ("min", lambda a, b, s: a.min_component())):
            close(f(ta, tb, ts), f(ja, jb, js), dt, name)
        close(tv.Vec3.where(ts > 0, ta, tb), jv.Vec3.where(js > 0, ja, jb),
              dt, "where")
        m = rng(4).normal(size=(4, 4))
        jm, tm = both(m, dt)
        close(tv.mat_apply_point(tm, ta), jv.mat_apply_point(jm, ja), dt)
        close(tv.mat_apply_vector(tm, ta), jv.mat_apply_vector(jm, ja), dt)
        cols = rng(5).normal(size=(6, 12))
        jc, tc = both(cols, dt)
        oi = rng(6).integers(0, 6, R)
        joi, toi = jnp.asarray(oi, jnp.int32), torch.from_numpy(oi)
        close(tv.mat_gather_apply_point(tc, toi, ta),
              jv.mat_gather_apply_point(jc, joi, ja), dt)
        close(tv.mat_gather_apply_vector(tc, toi, ta),
              jv.mat_gather_apply_vector(jc, joi, ja), dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_sampling(dt):
    with jax_dtype(dt):
        jp, tp = both(np.arange(R) % 300, dt)
        close(tsam.sunflower(256, 2.0, tp), jsam.sunflower(256, 2.0, jp), dt)
        (ju1, tu1), (ju2, tu2) = (both(rng(k).random(R), dt) for k in (7, 8))
        jn, tn = vec(unit(9), dt)
        close(tsam.random_vector_in_hemisphere(tn, tu1, tu2),
              jsam.random_vector_in_hemisphere(jn, ju1, ju2), dt)
        close(tsam.random_point_on_sphere(1.0, tu1, tu2),
              jsam.random_point_on_sphere(1.0, ju1, ju2), dt)
        je, te = vec(unit(10), dt)
        jr, tr = both(rng(11).choice([1.0, 1.5, 2.4, -1.0], R), dt)
        one = np.asarray(1.0, dt)
        for n1, n2 in ((one, 1.5), ("r", one), (one, "r")):
            a = [jr if x == "r" else x for x in (n1, n2)]
            b = [tr if isinstance(x, str) else x for x in (n1, n2)]
            close(tsam.schlick(te, tn, *b), jsam.schlick(je, jn, *a), dt,
                  f"schlick {n1} {n2}")
            close(tsam.refracted_direction(te, tn, *b),
                  jsam.refracted_direction(je, jn, *a), dt, "refract")


@pytest.mark.parametrize("dt", DTYPES)
def test_uv_maps_and_samplers(dt):
    with jax_dtype(dt):
        jp, tp = vec(unit(12), dt)
        close(tuv.spherical_map(tp), juv.spherical_map(jp), dt, "sphere")
        # points on the unit cube's faces, away from its edges
        c = rng(13).uniform(-0.95, 0.95, (3, R))
        face = rng(14).integers(0, 3, R)
        c[face, np.arange(R)] = rng(15).choice([-1.0, 1.0], R)
        jc, tc = vec(c, dt)
        close(tuv.cube_uv(tc), juv.cube_uv(jc), dt, "cube")
        (ju, tu), (jw, tw) = (both(rng(k).uniform(-2, 3, R), dt)
                              for k in (16, 17))
        atlas = rng(18).random((3, 2, 5, 7))
        ja, ta = both(atlas, dt)
        layer = rng(19).integers(0, 2, R)
        jl, tl = jnp.asarray(layer, jnp.int32), torch.from_numpy(layer)
        close(tuv.sample_texture(ta, tl, tu, tw),
              juv.sample_texture(ja, jl, ju, jw), dt, "atlas")
        # the rgb8 pool: two textures, per-ray (base, w, h)
        pool = rng(20).integers(0, 2 ** 24, 5 * 7 + 3 * 4).astype(np.uint32)
        which = rng(21).integers(0, 2, R)
        base, w, h = (np.where(which, a, b) for a, b in
                      ((35, 0), (4, 7), (3, 5)))
        jb, tb = zip(*(both(x, dt) for x in (base, w, h)))
        want = juv.sample_texture_pool(jnp.asarray(pool), *jb, ju, jw)
        got = tuv.sample_texture_pool(torch.from_numpy(pool.view(np.int32))
                                      .view(torch.uint32), *tb, tu, tw)
        close(got, want, dt, "pool")


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("aperture", [0.0, 0.2])
def test_rays_for_pixels(dt, aperture):
    from pathtracer_tpu.scenes import get_scene as jget
    from pathtracer_tpu_torch.scenes import get_scene as tget

    kw = dict(width=40, height=30, aperture=aperture, focal_length=1.6)
    jc, tc = jget("reference", JaxConfig(**kw)).camera, tget(
        "reference", RenderConfig(**kw)).camera
    with jax_dtype(dt):
        P = 40 * 30
        px, py = np.arange(P) % 40, np.arange(P) // 40
        (jx, tx), (jy, ty) = (both(rng(k).random(P), dt) for k in (22, 23))
        sid = np.arange(P) % 8
        want = jcam.rays_for_pixels(
            jc.pack(jnp.float64 if dt == "float64" else jnp.float32),
            jnp.asarray(px, jnp.int32), jnp.asarray(py, jnp.int32), jx, jy,
            jnp.asarray(sid, jnp.int32), 8)
        got = tcam.rays_for_pixels(
            tc.pack(getattr(torch, dt)), torch.from_numpy(px.astype(np.int32)),
            torch.from_numpy(py.astype(np.int32)), tx, ty,
            torch.from_numpy(sid.astype(np.int32)), 8)
        close(got, want, dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_slab_and_primitive_tests(dt):
    with jax_dtype(dt):
        jo, to = vec(rng(24).uniform(-3, 3, (3, R)), dt)
        jd, td = vec(unit(25), dt)
        jlo, tlo = vec(rng(26).uniform(-1, 0, (3, R)), dt)
        jhi, thi = vec(rng(27).uniform(0, 1, (3, R)), dt)
        close(tint.slab_test(to, td, tlo, thi, 1e-4),
              jint.slab_test(jo, jd, jlo, jhi, 1e-4), dt, "slab")
        close(tint._plane_t(to, td, 1e-4), jint._plane_t(jo, jd, 1e-4), dt)
        close(tint._sphere_t(to, td, 1e-4), jint._sphere_t(jo, jd, 1e-4), dt)
        close(tint._box_t(to, td, 1e-4), jint._box_t(jo, jd, 1e-4), dt)
        jy0, ty0 = both(0.0, dt)
        jy1, ty1 = both(0.7, dt)
        close(tint._cylinder_t(to, td, ty0, ty1, 1e-4),
              jint._cylinder_t(jo, jd, jy0, jy1, 1e-4), dt)


@pytest.fixture(scope="module")
def scenes():
    """(JAX arrays, meta, port scene) of `reference` and `teapot` (the JAX
    side on its NumPy path: the port's scene-core), per dtype."""
    out = {}
    for name in ("reference", "teapot", "textures"):
        with mock.patch.object(jnative, "available", lambda: False):
            js, _, ts, _ = scene_pair(name, width=8, height=6)
        out[name] = (js, ts)
    return out


def _pack_pair(scenes, name, dt):
    js, ts = scenes[name]
    with jax_dtype(dt), mock.patch.object(jnative, "available",
                                          lambda: False):
        ja, jm = jax_pack(js, ts, dtype=getattr(jnp, dt))
    ta, tm = ts.pack(device=CPU, dtype=getattr(torch, dt))
    return ja, jm, ta, tm


def _rays(k, n=R, spread=0.6):
    """n rays from points in a box of half-side `spread`."""
    o = rng(k).uniform(-spread, spread, (3, n))
    return o, unit(k + 1, n)


def _hit_rule(got, want, dt):
    """The intersections' rule (module docstring)."""
    agree = np.ones(got.t.shape[0], bool)
    for f in ("obj_idx", "is_tri", "tri_slot"):
        agree &= np.asarray(getattr(want, f)) == getattr(got, f).numpy()
    assert (~agree).mean() <= DISCRETE_FRAC
    for f in ("t", "tri_u", "tri_v"):
        g, w = getattr(got, f).numpy()[agree], np.asarray(
            getattr(want, f))[agree]
        np.testing.assert_allclose(g, w, err_msg=f, **JIT_TOL[dt])
    for f in ("local_origin", "local_dir"):
        for g, w in zip(getattr(got, f), getattr(want, f)):
            np.testing.assert_allclose(g.numpy()[agree], np.asarray(w)[agree],
                                       err_msg=f, **JIT_TOL[dt])


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", ["reference", "teapot"])
def test_intersect_scene_and_bvh_walk(scenes, name, dt):
    # the JAX walk under jit (eager, a while_loop steps in Python, slowly):
    # XLA may fuse multiply-adds there, within TOL
    ja, jm, ta, tm = _pack_pair(scenes, name, dt)
    o, d = _rays(30)
    with jax_dtype(dt, eager=False):
        (jo, to), (jd, td) = vec(o, dt), vec(d, dt)
        want = jax.jit(jint.intersect_scene, static_argnums=(1, 4, 5))(
            ja, jm, jo, jd, 1e-4, 1024.0)
        got = tint.intersect_scene(ta, tm, to, td, 1e-4, 1024.0)
        _hit_rule(got, want, dt)
        assert bool(got.is_tri.any()) == tm.has_groups
        if tm.has_groups:
            g, root, end = tm.group_bvh[0]
            inv = ta.inverse[g]
            lo = tv.mat_apply_point(inv, to)
            ld = tv.mat_apply_vector(inv, td)
            jinv = ja.inverse[g]
            st = tint.traverse_bvh(ta, lo, ld, root, end, tm.leaf_size, 1e-4,
                                   1024.0)
            sj = jax.jit(jint.traverse_bvh, static_argnums=range(3, 8))(
                ja, jv.mat_apply_point(jinv, jo),
                jv.mat_apply_vector(jinv, jd), root, end, jm.leaf_size,
                1e-4, 1024.0)
            same = st.best_slot.numpy() == np.asarray(sj.best_slot)
            assert (~same).mean() <= DISCRETE_FRAC
            assert (st.best_slot >= 0).any()
            np.testing.assert_allclose(st.best_t.numpy()[same],
                                       np.asarray(sj.best_t)[same], **JIT_TOL[dt])


def _attrs_inputs(tm, k=40):
    """Per-ray objects (every textured one and the rest) and local points
    on them."""
    oi = rng(k).integers(0, tm.n_objects, R)
    lp = rng(k + 1).uniform(-1, 1, (3, R))
    return oi, lp


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("trainable", [False, True])
def test_object_attrs_normals_and_colors(scenes, dt, trainable):
    # `textures`: textured planes (one with a normal map), spheres and a
    # box; the port fetches every texel from the pool, where the JAX
    # package evaluates the programs in f32 (its computed-texel mode) and
    # fetches the pool in f64; trainable textures sample the float atlases
    ja, jm, ta, tm = _pack_pair(scenes, "textures", dt)
    assert tm.textured_types and tm.has_normal_maps
    jcfg = JaxConfig(dtype=dt, trainable_textures=trainable)
    tcfg = RenderConfig(dtype=dt, trainable_textures=trainable)
    assert jit_._use_computed_tex(jm, jcfg) == (dt == "float32"
                                                and not trainable)
    oi, lp = _attrs_inputs(tm)
    with jax_dtype(dt):
        joi, toi = jnp.asarray(oi, jnp.int32), torch.from_numpy(
            oi.astype(np.int32))
        jat = jit_._fetch_object_attrs(ja, joi)
        tat = tit._fetch_object_attrs(ta, toi)
        for f in tit.ObjAttrs._fields:
            close(getattr(tat, f), getattr(jat, f), dt, f)
        jlp, tlp = vec(lp, dt)
        jtn, ttn = vec(unit(42), dt)
        jtc, ttc = vec(rng(43).random((3, R)), dt)
        tri = rng(44).random(R) < 0.1
        jtri, ttri = jnp.asarray(tri), torch.from_numpy(tri)
        close(tit._surface_normal(ta, tm, tcfg, tat, tlp, ttn, ttri, 1e-4),
              jit_._surface_normal(ja, jm, jcfg, jat, jlp, jtn, jtri, 1e-4,
                                   obj_idx=joi), dt, "normal")
        got = tit._surface_color(ta, tm, tcfg, tat, tlp, ttc, ttri)
        want = jit_._surface_color(ja, jm, jcfg, jat, jlp, jtc, jtri,
                                   obj_idx=joi)
        close(got, want, dt, "color", TEX_TOL)


def test_quad_pool_fetch_equals_take4(monkeypatch):
    # PT_TEX_FETCH=quad: the one-row fetch of the wavefront's pool path
    # equals the four taps bit for bit (as tests/test_uv.py holds for the
    # JAX package), and the JAX package's quad fetch
    monkeypatch.setenv("PT_TEX_FETCH", "quad")
    # the JAX package fetches procedural texels only in its gather mode
    monkeypatch.setenv("PT_TEX_MODE", "gather")
    with mock.patch.object(jnative, "available", lambda: False):
        js, _, ts, _ = scene_pair("textures", width=8, height=6)
        ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device=CPU)
    assert np.array_equal(ta.tex_pool_quad_u32.numpy(),
                          np.asarray(ja.tex_pool_quad_u32))
    assert tit._quad_pool(ta) is ta.tex_pool_quad_u32
    oi, lp = _attrs_inputs(tm, k=50)
    cfg = RenderConfig()
    tat = tit._fetch_object_attrs(ta, torch.from_numpy(oi.astype(np.int32)))
    tlp = tv.Vec3(*(torch.from_numpy(c.astype(np.float32)) for c in lp))
    zero = tv.Vec3.zeros((R,))
    no_tri = torch.zeros(R, dtype=torch.bool)
    quad = tit._surface_color(ta, tm, cfg, tat, tlp, zero, no_tri)
    monkeypatch.setenv("PT_TEX_FETCH", "take4")
    assert tit._quad_pool(ta) is None
    take4 = tit._surface_color(ta, tm, cfg, tat, tlp, zero, no_tri)
    for a, b in zip(quad, take4):
        assert torch.equal(a, b)
    monkeypatch.setenv("PT_TEX_FETCH", "quad")
    with jax.disable_jit():
        jat = jit_._fetch_object_attrs(ja, jnp.asarray(oi, jnp.int32))
        want = jit_._surface_color(
            ja, jm, JaxConfig(), jat,
            jv.Vec3(*(jnp.asarray(c, jnp.float32) for c in lp)),
            jv.Vec3.zeros((R,)), jnp.zeros(R, bool))
    close(quad, want, "float32", "quad vs JAX", TEX_TOL)


@pytest.mark.parametrize("name", ["reference", "teapot", "textures"])
def test_kernel_route_matches_the_walk(scenes, name):
    # the intersect kernel's route (its plain version on the CPU) against
    # the torch walk: the same object on every ray but counted exact ties
    _, _, ta, tm = _pack_pair(scenes, name, "float32")
    cfg = RenderConfig()
    o, d = _rays(60, spread=0.9)
    to = tv.Vec3(*(torch.from_numpy(c.astype(np.float32)) for c in o))
    td = tv.Vec3(*(torch.from_numpy(c.astype(np.float32)) for c in d))
    route = tit.intersect_route(ta, tm, cfg, fn=mk.intersect_batch_reference)
    hit, _ = tit._route_hit(route, ta, tm, cfg, to, td)
    t, oi, is_tri = hit.t, hit.obj_idx, hit.is_tri
    walk = tint.intersect_scene(ta, tm, to, td, cfg.epsilon, cfg.t_max)
    differ = oi != walk.obj_idx
    ties = differ & (t == walk.t)
    assert int((differ & ~ties).sum()) == 0, int(differ.sum())
    same = ~differ
    np.testing.assert_allclose(t[same].numpy(), walk.t[same].numpy(),
                               **TOL["float32"])
    assert torch.equal(is_tri[same], walk.is_tri[same])
    # the kernel's triangle slot is the walk's winner
    assert torch.equal(hit.tri_slot[same], walk.tri_slot[same])
    # the route a CPU render takes by default is the walk's
    assert tit.intersect_route(ta, tm, cfg).fn is None
