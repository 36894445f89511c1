"""Wavefront path-tracing integrator (SoA Vec3 layout, render/vec3.py).

Counterpart of pathtracer_tpu.render.integrator, the JAX package's second
backend: the reference megakernel's sample/bounce/resolve loops
(tracer.cl:867-1187) as whole-batch torch ops, one bounce of every live
ray at a time, in f32 or f64 on the tensors' device. Semantics as there:
at most 10 bounces and 4 "effective" ones (reflection and refraction
bounces are free, tracer.cl:884, 1098-1101); the resolve pass folded
forward into a running (mask, accum); a light hit on the first recorded
bounce returns the light's color (tracer.cl:1107, 1156-1163); the
thin-shell refractiveIndex == -1 hack (tracer.cl:989-1004); the
reflectivity and Schlick roulettes with inside tracking (tracer.cl:982,
1006-1054); cos = 1 for non-diffuse bounces (tracer.cl:975); triangle
hits take the triangle's color and no emission (tracer.cl:672-673,
1071-1073); optional next-event estimation (tracer.cl:786-829).

The random stream is the JAX package's: threefry keys folded per pass,
bounce and light (render/threefry.py), uniforms drawn in f32 in both
precisions, so the two packages trace the same paths.

The nearest hit (`IntersectRoute`): on a CUDA device, in f32, every
bounce and every NEE shadow ray goes through the intersect-only kernel,
megakernel.intersect_batch (csrc/megakernel.cu `intersect`, K5), with its
tables built once per render, in the early-exit loop and in the
fixed-trip loop of the differentiable path alike. Everywhere else (f64,
the CPU) they take the torch walk, render/intersect.py, as the JAX package
falls back to its XLA walk off its chip (its _use_pallas_intersect).
Unlike the JAX package, which sends only mesh scenes to its kernel and
keeps it off its autograd path ("the kernel has no VJP"), the route takes
primitive scenes and autograd too: a nearest hit is a discrete choice,
and the pathwise gradient of colors, emission, triangle colors and texels
runs through the winner's attributes, gathered here by the winner's
object and triangle slot. Where the rays themselves carry a gradient (a
normal map sampled from a trainable atlas bends the next direction), the
winner's t, object-space ray and barycentrics are recomputed by the walk's
own operations (intersect.reattach_hit), so the gradient is the walk's:
the derivative of a min is that of its argmin's branch.

Texels: every texture but a trainable one is fetched from the rgb8 pool
(uv.sample_texture_pool, one quad row per fetch under PT_TEX_FETCH=quad),
procedural ones too: the JAX package evaluates their programs in f32
(its computed-texel mode, _sample_proc), which is the same bilinear fetch
of the image the pool holds. Trainable textures sample the float atlases.
"""
from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import RenderConfig
from ..scene.pack import SceneArrays, SceneMeta
from ..scene.shapes import BOX, CYLINDER, PLANE, SPHERE
from ..spans import span
from . import megakernel as mk
from . import threefry
from .camera import Camera, CameraArrays, rays_for_pixels
from .intersect import Hit, intersect_scene, reattach_hit
from .sampling import (random_point_on_sphere, random_vector_in_hemisphere,
                       refracted_direction, schlick)
from .uv import cube_uv, sample_texture, sample_texture_pool, spherical_map
from .vec3 import Vec3


class IntersectRoute(NamedTuple):
    """Where a render's nearest hits come from: `fn` (megakernel.
    intersect_batch, or a function of its signature, such as its plain
    version) with the intersect tables built once for the render, or, with
    fn None, the torch walk (intersect.intersect_scene)."""
    fn: Optional[Callable] = None
    tables: Optional[tuple] = None


def kernel_route_applies(meta: SceneMeta, cfg: RenderConfig, device) -> bool:
    """Whether a render takes K5: a CUDA device, f32 and a scene
    intersect_batch supports (the fixed-trip loop too)."""
    return (torch.device(device).type == "cuda"
            and cfg.dtype == "float32" and mk.supports_intersect(meta))


def intersect_route(scn: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
                    fn: Optional[Callable] = None) -> IntersectRoute:
    """The route of a render of `scn`: K5 (megakernel.intersect_batch)
    where kernel_route_applies, else the torch walk. `fn` forces the
    kernel's route with that function (an f32 scene intersect_batch
    supports), e.g. megakernel.intersect_batch_reference."""
    dev = scn.color.device
    if fn is None:
        if not kernel_route_applies(meta, cfg, dev):
            return IntersectRoute()
        fn = mk.intersect_batch
    elif scn.color.dtype != torch.float32 or not mk.supports_intersect(meta):
        raise ValueError("the intersect kernel's route takes f32 scenes of "
                         "primitives and groups")
    return IntersectRoute(fn, mk.intersect_tables(scn, meta, dev))


def _needs_grad(*vs: Vec3) -> bool:
    return any(c.requires_grad for v in vs for c in v)


def _route_hit(route: IntersectRoute, scn, meta, cfg, origin: Vec3,
               direction: Vec3) -> Tuple[Hit, Vec3]:
    """route.fn on contiguous f32 rays (detached): (the Hit, the winning
    triangle's smooth normal), in the rays' dtype. Where origin or
    direction require a gradient, the winner is re-attached
    (intersect.reattach_hit) and the smooth normal is the walk's, from the
    re-attached barycentrics; else both are the kernel's."""
    dt = origin.x.dtype
    o = tuple(a.detach().to(torch.float32).contiguous() for a in origin)
    d = tuple(a.detach().to(torch.float32).contiguous() for a in direction)
    t, oi, lo, ld, is_tri, tn, _, slot = route.fn(scn, meta, cfg, o, d,
                                                  tables=route.tables)

    def v(a):
        return Vec3(*(c.to(dt) for c in a))
    t = t.to(dt)
    if not _needs_grad(origin, direction):
        zero = torch.zeros_like(t)
        return Hit(t=t, obj_idx=oi, local_origin=v(lo), local_dir=v(ld),
                   is_tri=is_tri, tri_slot=slot, tri_u=zero,
                   tri_v=zero), v(tn)
    hit = reattach_hit(scn, meta, origin, direction, oi, slot, t,
                       cfg.epsilon, cfg.t_max)
    return hit, _smooth_normal(scn, meta, hit)


def _smooth_normal(scn: SceneArrays, meta: SceneMeta, hit: Hit) -> Vec3:
    """The winning triangle's smooth normal n2*u + n3*v + n1*(1-u-v)
    (tracer.cl:669), gathered by its slot (0 where no mesh)."""
    if not meta.has_groups:
        return Vec3.zeros(hit.t.shape, hit.t.dtype, hit.t.device)
    slot = torch.clamp(hit.tri_slot, 0, scn.tri_p1.shape[0] - 1).long()
    w1 = 1.0 - hit.tri_u - hit.tri_v
    return (_gather_vec(scn.tri_n2, slot) * hit.tri_u
            + _gather_vec(scn.tri_n3, slot) * hit.tri_v
            + _gather_vec(scn.tri_n1, slot) * w1)


def _tex_sampler(scn: SceneArrays, kind: str):
    """Float-atlas texture fetch (the differentiable path's)."""
    atlas = getattr(scn, f"tex_{kind}")
    return lambda li, u, v: sample_texture(atlas, li, u, v)


class PathState(NamedTuple):
    origin: Vec3
    direction: Vec3
    mask: Vec3
    accum: Vec3
    alive: torch.Tensor     # [R] bool
    inside: torch.Tensor    # [R] bool
    n_hits: torch.Tensor    # [R] i32 recorded bounces
    eff: torch.Tensor       # [R] i32 effective bounces


def _gather_vec(table: torch.Tensor, idx: torch.Tensor) -> Vec3:
    """Row gathers from a small [N, 3] table -> Vec3 of [R], by
    index_select, whose backward adds with index_add_ (advanced indexing's
    sorts the indices and adds each run of equal ones in turn: a million
    rays on a few rows serialize)."""
    rows = torch.index_select(table, 0, idx.long())
    return Vec3(rows[:, 0], rows[:, 1], rows[:, 2])


class ObjAttrs(NamedTuple):
    """Per-ray object attributes of the winning hit, all [R]."""
    color: Vec3
    emission: Vec3
    refractive_index: torch.Tensor
    reflectivity: torch.Tensor
    min_y: torch.Tensor
    max_y: torch.Tensor
    inv_t: Tuple[torch.Tensor, ...]   # 12 rows: 3x4 inverse-transpose
    obj_type: torch.Tensor            # float codes (exact for small ints)
    is_textured: torch.Tensor
    texture_index: torch.Tensor       # i32
    texture_scale: Tuple[torch.Tensor, torch.Tensor]
    is_textured_nm: torch.Tensor
    texture_index_nm: torch.Tensor    # i32
    texture_scale_nm: Tuple[torch.Tensor, torch.Tensor]
    # flat-pool fetch coordinates (f32-exact; pack._build_texel_pool)
    tex_base: torch.Tensor
    tex_w: torch.Tensor
    tex_h: torch.Tensor
    tex_nm_base: torch.Tensor
    tex_nm_w: torch.Tensor
    tex_nm_h: torch.Tensor


def _quad_pool(scn: SceneArrays):
    """The quad pool under PT_TEX_FETCH=quad (one row gather a bilinear
    fetch, the same result as the four taps), else None; None too for a
    scene packed without it."""
    if os.environ.get("PT_TEX_FETCH", "take4") == "quad":
        if scn.tex_pool_quad_u32.shape[0] != scn.tex_pool_u32.shape[0]:
            return None
        return scn.tex_pool_quad_u32
    return None


def _fetch_object_attrs(scn: SceneArrays, oi: torch.Tensor) -> ObjAttrs:
    """Every per-object attribute of each ray's object, by two gathers of
    the columns of [C, No] attribute tables (the JAX package contracts a
    one-hot matrix with one table on the TPU's matrix unit, at full
    precision: the same values): the trainable color and emission apart
    (an index_select, whose backward adds with index_add_; _gather_vec),
    so that nothing else gathered carries the autograd graph of a
    differentiable render (integrator._route_hit re-attaches the winner
    only where the rays really depend on a parameter)."""
    dt = scn.color.dtype

    def f(a):
        return a.to(dt)
    oi = oi.long()
    trained = torch.index_select(
        torch.cat([scn.color.T, scn.emission.T], dim=0), 1, oi)
    table = torch.cat([
        scn.refractive_index[None, :],          # 0
        scn.reflectivity[None, :],              # 1
        scn.min_y[None, :],                     # 2
        scn.max_y[None, :],                     # 3
        scn.inv_t_affine.T,                     # 4-15
        f(scn.obj_type)[None, :],               # 16
        f(scn.is_textured)[None, :],            # 17
        f(scn.texture_index)[None, :],          # 18
        scn.texture_scale.T,                    # 19-20
        f(scn.is_textured_nm)[None, :],         # 21
        f(scn.texture_index_nm)[None, :],       # 22
        scn.texture_scale_nm.T,                 # 23-24
        f(scn.tex_base)[None, :],               # 25
        f(scn.tex_w)[None, :],                  # 26
        f(scn.tex_h)[None, :],                  # 27
        f(scn.tex_nm_base)[None, :],            # 28
        f(scn.tex_nm_w)[None, :],               # 29
        f(scn.tex_nm_h)[None, :],               # 30
    ], dim=0)
    attrs = table[:, oi]                         # [C, R]
    return ObjAttrs(
        color=Vec3(trained[0], trained[1], trained[2]),
        emission=Vec3(trained[3], trained[4], trained[5]),
        refractive_index=attrs[0],
        reflectivity=attrs[1],
        min_y=attrs[2],
        max_y=attrs[3],
        inv_t=tuple(attrs[4 + k] for k in range(12)),
        obj_type=attrs[16],
        is_textured=attrs[17],
        texture_index=attrs[18].to(torch.int32),
        texture_scale=(attrs[19], attrs[20]),
        is_textured_nm=attrs[21],
        texture_index_nm=attrs[22].to(torch.int32),
        texture_scale_nm=(attrs[23], attrs[24]),
        tex_base=attrs[25],
        tex_w=attrs[26],
        tex_h=attrs[27],
        tex_nm_base=attrs[28],
        tex_nm_w=attrs[29],
        tex_nm_h=attrs[30],
    )


def _mat12_apply_vector(m: Tuple[torch.Tensor, ...], v: Vec3) -> Vec3:
    """Apply per-ray 3x4 matrices given as 12 [R] row streams."""
    return Vec3(
        m[0] * v.x + m[1] * v.y + m[2] * v.z,
        m[4] * v.x + m[5] * v.y + m[6] * v.z,
        m[8] * v.x + m[9] * v.y + m[10] * v.z,
    )


def _surface_normal(scn: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
                    at: ObjAttrs, lp: Vec3, tri_normal: Vec3, is_tri,
                    eps) -> Vec3:
    """Object-space normal by primitive type (tracer.cl:903-950)."""
    obj_type = at.obj_type
    min_y, max_y = at.min_y, at.max_y
    zero = torch.zeros_like(lp.x)
    one = torch.ones_like(zero)

    # PLANE: +Y, or the normal-map texture (tracer.cl:906-914)
    n_plane = Vec3(zero, one, zero)
    if meta.has_normal_maps:
        has_nm = (at.is_textured_nm == 1) & (obj_type == PLANE)
        nm_sx, nm_sy = at.texture_scale_nm
        nm_u = torch.abs(lp.x) * nm_sx
        nm_v = torch.abs(lp.z) * nm_sy
        if not cfg.trainable_textures:
            nm_rgb = sample_texture_pool(
                scn.tex_pool_u32, at.tex_nm_base, at.tex_nm_w, at.tex_nm_h,
                nm_u, nm_v, pool_quad_u32=_quad_pool(scn)).normalized()
        else:
            nm_rgb = _tex_sampler(scn, "planar")(
                at.texture_index_nm, nm_u, nm_v).normalized()
        n_plane = Vec3.where(has_nm, nm_rgb, n_plane)

    # SPHERE: the local point minus the origin (tracer.cl:915-920): lp

    # CYLINDER incl. cap normals (tracer.cl:921-932)
    dist = lp.x * lp.x + lp.z * lp.z
    top = (dist < 1.0) & (lp.y >= max_y - eps)
    bottom = (dist < 1.0) & (lp.y <= min_y + eps)
    n_cyl = Vec3.where(
        top, Vec3(zero, one, zero),
        Vec3.where(bottom, Vec3(zero, -one, zero), Vec3(lp.x, zero, lp.z)),
    )

    # CUBE: the dominant axis (tracer.cl:933-946)
    a = lp.abs()
    maxc = a.max_component()
    sel_x = maxc == a.x
    sel_y = (~sel_x) & (maxc == a.y)
    n_box = Vec3.where(
        sel_x, Vec3(lp.x, zero, zero),
        Vec3.where(sel_y, Vec3(zero, lp.y, zero), Vec3(zero, zero, lp.z)),
    )

    n = Vec3.where(obj_type == PLANE, n_plane,
        Vec3.where(obj_type == SPHERE, lp,
        Vec3.where(obj_type == CYLINDER, n_cyl,
        Vec3.where(obj_type == BOX, n_box, tri_normal))))
    return Vec3.where(is_tri, tri_normal, n)


def _surface_color(scn: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
                   at: ObjAttrs, lp: Vec3, tri_color: Vec3, is_tri) -> Vec3:
    """Surface color including the texture lookups (tracer.cl:1075-1093);
    a type's sampling runs only when an object of that type is textured
    (meta.textured_types)."""
    base = at.color
    obj_type = at.obj_type
    if meta.textured_types:
        # only plane/sphere/box have texture mappings (tracer.cl:1077-1093)
        textured = (at.is_textured == 1) & (
            (obj_type == PLANE) | (obj_type == SPHERE) | (obj_type == BOX))
        sx, sy = at.texture_scale

        if not cfg.trainable_textures:
            # one UV per ray, selected by type, then one texel fetch
            u = lp.x * sx
            v = lp.z * sy
            if SPHERE in meta.textured_types:
                us, vs = spherical_map(lp)
                sel = obj_type == SPHERE
                u = torch.where(sel, us, u)
                v = torch.where(sel, 1.0 - vs, v)
            if BOX in meta.textured_types:
                uc, vc = cube_uv(lp)
                sel = obj_type == BOX
                u = torch.where(sel, uc, u)
                v = torch.where(sel, vc, v)
            tex_color = sample_texture_pool(
                scn.tex_pool_u32, at.tex_base, at.tex_w, at.tex_h,
                u, v, pool_quad_u32=_quad_pool(scn))
        else:
            # the per-kind float atlases
            tex_idx = at.texture_index
            tex_color = base
            if PLANE in meta.textured_types:
                c_plane = _tex_sampler(scn, "planar")(
                    tex_idx, lp.x * sx, lp.z * sy)
                tex_color = Vec3.where(obj_type == PLANE, c_plane,
                                       tex_color)
            if SPHERE in meta.textured_types:
                us, vs = spherical_map(lp)
                c_sphere = _tex_sampler(scn, "sphere")(tex_idx, us, 1.0 - vs)
                tex_color = Vec3.where(obj_type == SPHERE, c_sphere,
                                       tex_color)
            if BOX in meta.textured_types:
                uc, vc = cube_uv(lp)
                c_cube = _tex_sampler(scn, "cube")(tex_idx, uc, vc)
                tex_color = Vec3.where(obj_type == BOX, c_cube, tex_color)

        base = Vec3.where(textured, tex_color, base)
    return Vec3.where(is_tri, tri_color, base)


def _uniform(key: torch.Tensor, n: int, R: int, dt, device):
    """n rows of R f32 uniforms (jax.random.uniform(key, (n, R))), in dt."""
    return threefry.uniform(key, (n, R), device).to(dt)


def _next_event_estimation(scn: SceneArrays, meta: SceneMeta,
                           cfg: RenderConfig, position: Vec3, normal: Vec3,
                           color: Vec3, mask: Vec3, cond: torch.Tensor,
                           key: torch.Tensor,
                           route: IntersectRoute) -> Vec3:
    """Explicit light sampling (tracer.cl:786-829) over the pack-time
    emissive objects (meta.light_indices), one shadow ray each."""
    R = position.x.shape[0]
    dt = position.x.dtype
    dev = position.x.device
    eps = cfg.epsilon
    out = Vec3.zeros((R,), dt, dev)

    for li, l in enumerate(meta.light_indices):
        u1, u2 = _uniform(threefry.fold_in(key, li), 2, R, dt, dev)
        # the light's origin from the transform's translation column, its
        # scale from the largest diagonal element (tracer.cl:790-791)
        tr = scn.transform[l]
        origin = Vec3(*(torch.broadcast_to(tr[k, 3], (R,)) for k in range(3)))
        scale_by = torch.maximum(torch.maximum(tr[0, 0], tr[1, 1]), tr[2, 2])
        rpos = random_point_on_sphere(1.0, u1, u2)
        light_pos = origin + rpos * scale_by

        sdir = (light_pos - position).normalized()
        sorigin = position + sdir * eps
        ldn = sdir.dot(normal)

        with span("pt.bounce.intersect"):
            if route.fn is not None:
                hit, _ = _route_hit(route, scn, meta, cfg, sorigin, sdir)
            else:
                hit = intersect_scene(scn, meta, sorigin, sdir, eps,
                                      cfg.t_max)
        sh_t, sh_idx = hit.t, hit.obj_idx
        visible = (cond & (ldn > 0.0) & (sh_idx == l)
                   & (sh_t > eps) & (sh_t < cfg.t_max))
        # the reference's attenuation heuristic (tracer.cl:819)
        atten = 1.0 - sh_t / torch.sqrt(sh_t * sh_t + tr[0, 0] * tr[0, 0])
        eff = color * Vec3(scn.emission[l, 0], scn.emission[l, 1],
                           scn.emission[l, 2])
        contrib = eff * mask * (ldn * atten)
        out = out + Vec3.where(visible, contrib, Vec3.zeros((R,), dt, dev))
    return out


def bounce_step(scn: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
                state: PathState, key: torch.Tensor,
                route: IntersectRoute = IntersectRoute()) -> PathState:
    """One bounce of every ray of the batch, in the span "pt.bounce" and
    its parts "pt.bounce.intersect", "pt.bounce.attrs" and
    "pt.bounce.shade" (spans.py)."""
    o = state.origin.x
    with span("pt.bounce"):
        with span("pt.bounce.intersect"):
            if route.fn is not None:
                hit, tri_normal = _route_hit(route, scn, meta, cfg,
                                             state.origin, state.direction)
            else:
                hit = intersect_scene(scn, meta, state.origin,
                                      state.direction, cfg.epsilon,
                                      cfg.t_max)
                tri_normal = _smooth_normal(scn, meta, hit)
        with span("pt.bounce.attrs"):
            # the triangle's color, gathered by the winning slot
            # (differentiable)
            if meta.has_groups:
                tri_color = _gather_vec(scn.tri_color, torch.clamp(
                    hit.tri_slot, 0, scn.tri_p1.shape[0] - 1).long())
            else:
                tri_color = Vec3.zeros(o.shape, o.dtype, o.device)
            at = _fetch_object_attrs(scn, hit.obj_idx)
        with span("pt.bounce.shade"):
            return _shade(scn, meta, cfg, state, key, route, hit, tri_normal,
                          tri_color, at)


def _shade(scn: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
           state: PathState, key: torch.Tensor, route: IntersectRoute,
           hit: Hit, tri_normal: Vec3, tri_color: Vec3,
           at: ObjAttrs) -> PathState:
    """The rest of bounce_step, from the hit and its attributes: the
    normal, the material roulette, the surface color, NEE and the resolve
    pass folded forward."""
    eps = cfg.epsilon
    R = state.origin.x.shape[0]
    dt = state.origin.x.dtype
    dev = state.origin.x.device
    hit_ok = hit.t < cfg.t_max

    position = state.origin + state.direction * hit.t
    eye = -state.direction
    # the local hit point from the per-object ray the intersection kept
    local_point = hit.local_origin + hit.local_dir * hit.t

    n_local = _surface_normal(scn, meta, cfg, at, local_point, tri_normal,
                              hit.is_tri, eps)
    normal = _mat12_apply_vector(at.inv_t, n_local).normalized()
    # face-forward (tracer.cl:962-964)
    normal = Vec3.where(eye.dot(normal) < 0.0, -normal, normal)

    over = position + normal * eps
    under = position - normal * eps

    # drawn in f32 in both precisions: f64 renders take the same uniforms
    u_refl, u_schl, u1, u2 = _uniform(key, 4, R, dt, dev)

    refl = at.reflectivity
    refr = at.refractive_index
    one = torch.ones((), dtype=dt, device=dev)

    # --- material roulette (tracer.cl:982-1061) -----------------------
    do_reflect = (refl != 0.0) & (u_refl < refl)

    thin = (~do_reflect) & (refr == -1.0)
    sch_thin = schlick(eye, normal, 1.0, 1.5)
    thin_pass = thin & (sch_thin < u_schl)
    thin_reflect = thin & ~(sch_thin < u_schl)

    solid = (~do_reflect) & (~thin) & (refr != 1.0)
    outside = ~state.inside
    sch = torch.where(outside, schlick(eye, normal, one, refr),
                      schlick(eye, normal, refr, one))
    do_refract = solid & (sch < u_schl)
    refract_dir = Vec3.where(
        outside,
        refracted_direction(eye, normal, one, refr),
        refracted_direction(eye, normal, refr, one),
    )
    solid_reflect = solid & ~do_refract

    diffuse = (~do_reflect) & (~thin) & (~solid)
    hemi = random_vector_in_hemisphere(normal, u1, u2)

    reflect_dir = state.direction.reflect(normal)
    any_reflect = do_reflect | thin_reflect | solid_reflect

    new_dir = Vec3.where(any_reflect, reflect_dir,
              Vec3.where(thin_pass, state.direction,
              Vec3.where(do_refract, refract_dir, hemi)))
    cos = torch.where(diffuse, hemi.dot(normal), one)
    new_origin = Vec3.where(thin_pass | do_refract, under, over)

    entering = do_refract & outside
    exiting = do_refract & state.inside
    new_inside = torch.where(do_refract, outside, state.inside)
    is_refraction = entering | exiting

    color = _surface_color(scn, meta, cfg, at, local_point, tri_color,
                           hit.is_tri)
    zero = torch.zeros_like(color.x)
    zeros = Vec3(zero, zero, zero)
    emission = Vec3.where(hit.is_tri, zeros, at.emission)

    # --- the resolve pass folded forward (tracer.cl:1116-1176) --------
    rec = state.alive & hit_ok
    no_refr = rec & ~is_refraction
    is_light = emission.x > 0.0

    accum = state.accum + Vec3.where(no_refr, state.mask * emission, zeros)

    # next-event estimation (tracer.cl:786-829; disabled in the reference
    # at tracer.cl:1168, cfg.nee turns it on)
    if cfg.nee and meta.light_indices:
        nee_cond = no_refr & ~is_light
        accum = accum + _next_event_estimation(
            scn, meta, cfg, position, normal, color, state.mask, nee_cond,
            threefry.fold_in(key, 3), route)
    direct = no_refr & is_light & (state.n_hits == 0)
    accum = Vec3.where(direct, color, accum)
    mask = Vec3.where(no_refr & ~is_light, state.mask * color * cos,
                      state.mask)

    # effective bounces: all but refraction transits and reflections
    # (tracer.cl:1098-1101); a thin-shell pass-through counts
    eff = state.eff + (rec & ~is_refraction & ~any_reflect).to(torch.int32)
    n_hits = state.n_hits + rec.to(torch.int32)
    alive = (state.alive & hit_ok & ~(rec & is_light)
             & (eff < cfg.max_effective_bounces))

    return PathState(
        origin=Vec3.where(rec, new_origin, state.origin),
        direction=Vec3.where(rec, new_dir, state.direction),
        mask=mask,
        accum=accum,
        alive=alive,
        inside=torch.where(rec, new_inside, state.inside),
        n_hits=n_hits,
        eff=eff,
    )


def probe_line(b: int, i: int, s: PathState) -> str:
    """One bounce of ray i of the batch, in the JAX package's debug_ray
    format (the reference's per-pixel printf probes, tracer.cl:1015,
    1065-1067)."""
    v = [float(a[i].detach())
         for a in (*s.origin, *s.direction, *s.mask, *s.accum)]
    return (f"bounce {b} ray {i}: o=({v[0]:.5f},{v[1]:.5f},{v[2]:.5f}) "
            f"d=({v[3]:.5f},{v[4]:.5f},{v[5]:.5f}) mask=({v[6]:.4f},"
            f"{v[7]:.4f},{v[8]:.4f}) accum=({v[9]:.4f},{v[10]:.4f},"
            f"{v[11]:.4f}) alive={bool(s.alive[i])}")


def _remat_bounces(meta: SceneMeta) -> bool:
    """Whether the fixed-trip loop of a differentiable render may recompute
    a bounce in the backward pass instead of keeping its intermediates
    (torch.utils.checkpoint; the JAX package's jax.checkpoint of every
    bounce, render/integrator.py:661-678 there): where a bounce samples a
    texture or a normal map (the tables _surface_color and _surface_normal
    read: meta.textured_types, meta.has_normal_maps). A bounce of such a
    scene keeps about 1 KB a ray for its backward (on `textures`, about
    10 KB a ray over the 10 bounces, the texture and normal-map fetches
    and the re-attached hit most of it; tests/test_torch_wavefront_remat.py
    counts it); the checkpoint keeps the bounce's input
    state, 58 B a ray (origin, direction, mask, accum in f32; alive,
    inside, n_hits, eff), and one bounce's intermediates at a time. An
    untextured bounce keeps 43-51 B a ray, less than that state, so there
    the recompute would cost a forward a step and save nothing. The
    gradient is the same either way."""
    return bool(meta.textured_types) or meta.has_normal_maps


# Bytes a ray that one bounce of a scene _remat_bounces selects keeps for
# its backward, at most: 1,090-1,130 on `textures`, the largest, by the
# rays' paths (tests/test_torch_wavefront_remat.py holds every such scene
# under it).
_BOUNCE_BYTES = 1216


def _free_bytes(dev: torch.device) -> int:
    """Bytes that tensors on `dev` could still take: on a card its free
    memory and the blocks the caching allocator holds unused, on the CPU
    the host's available memory."""
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        return (free + torch.cuda.memory_reserved(dev)
                - torch.cuda.memory_allocated(dev))
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _plain_bounces(meta: SceneMeta, cfg: RenderConfig, n_rays: int,
                   dev: torch.device) -> int:
    """How many bounces of render_rays' loop, from the first, keep their
    intermediates for the backward; the others run under
    torch.utils.checkpoint. All of them, unless the loop is the
    differentiated fixed trip (no early exit, grad mode on) on a scene
    _remat_bounces selects and its bounces' intermediates (_BOUNCE_BYTES a
    ray each) would take more than three quarters of what is free on the
    rays' device; then as many as leave room in those three quarters for
    one recomputed bounce, the last quarter left to the backward's
    gradients and the checkpoints' states. So a batch that fits keeps the
    plain loop's rate (a recomputed bounce costs the step a forward of it
    and the checkpoint's hooks), and a larger one still runs."""
    n = cfg.max_bounces
    if (cfg.early_exit or not torch.is_grad_enabled()
            or not _remat_bounces(meta)):
        return n
    per = n_rays * _BOUNCE_BYTES
    room = _free_bytes(dev) * 3 // 4
    return n if n * per <= room else max(0, room // per - 1)


def render_rays(scn: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
                origin: Vec3, direction: Vec3, key: torch.Tensor,
                route: IntersectRoute = IntersectRoute()) -> Vec3:
    """Trace a batch of primary rays to completion; returns the radiance
    of each as a Vec3 of [R]. With cfg.early_exit the bounce loop stops
    once every ray has ended (the batch's analogue of the reference's
    per-ray break, tracer.cl:1107; one host check a bounce), else it runs
    cfg.max_bounces bounces with the dead rays masked (the same result):
    the loop reverse mode differentiates. There, with grad mode on, a
    scene whose bounces sample a texture or a normal map runs the bounces
    after the first _plain_bounces under torch.utils.checkpoint, as the
    JAX package's fixed-trip loop runs each under jax.checkpoint, where
    the batch's intermediates would not fit in memory: the backward pass
    recomputes such a bounce (K5 relaunches, the draws repeat bit for bit)
    from the state it kept. cfg.debug_ray >= 0 prints probe_line for that
    ray after each bounce (once: the recompute does not print)."""
    R = origin.x.shape[0]
    dt = origin.x.dtype
    dev = origin.x.device
    state = PathState(
        origin=origin,
        direction=direction,
        mask=Vec3.full((R,), 1.0, 1.0, 1.0, dt, dev),
        accum=Vec3.zeros((R,), dt, dev),
        alive=torch.ones((R,), dtype=torch.bool, device=dev),
        inside=torch.zeros((R,), dtype=torch.bool, device=dev),
        n_hits=torch.zeros((R,), dtype=torch.int32, device=dev),
        eff=torch.zeros((R,), dtype=torch.int32, device=dev),
    )
    n_plain = _plain_bounces(meta, cfg, R, dev)
    for b in range(cfg.max_bounces):
        if cfg.early_exit and not bool(state.alive.any()):
            break
        k = threefry.fold_in(key, b)
        if b >= n_plain:
            # the non-reentrant form: the trainable tensors sit inside
            # scn, which the reentrant form would leave without gradients
            state = checkpoint(bounce_step, scn, meta, cfg, state, k, route,
                               use_reentrant=False,
                               preserve_rng_state=False)
        else:
            state = bounce_step(scn, meta, cfg, state, k, route)
        if cfg.debug_ray >= 0:
            print(probe_line(b, cfg.debug_ray, state), flush=True)
    return state.accum


def pixel_grid(width: int, y0: int, y1: int, device,
               last_row: Optional[int] = None):
    """(px, py), int32 [(y1 - y0) * width] on `device`: the pixels of rows
    [y0, y1) of a `width`-wide image in row-major order; rows past
    `last_row` repeat it (the padding of a last, short row block)."""
    ys, xs = np.mgrid[y0:y1, 0:width]
    if last_row is not None:
        ys = np.minimum(ys, last_row)
    return (torch.from_numpy(xs.ravel().astype(np.int32)).to(device),
            torch.from_numpy(ys.ravel().astype(np.int32)).to(device))


def render_pass(scn: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
                cam: CameraArrays, px: torch.Tensor, py: torch.Tensor,
                sample0: int, n_samples: int, key: torch.Tensor,
                route: IntersectRoute = None) -> Vec3:
    """Render `n_samples` samples for each of P pixels (px, py: int32
    [P]); returns the SUM of the sample radiances as a Vec3 of [P] (the
    caller divides by the total spp). `route` defaults to
    intersect_route's."""
    if route is None:
        route = intersect_route(scn, meta, cfg)
    P = px.shape[0]
    S = n_samples
    dt = cam.inverse.dtype
    dev = px.device

    pxs = torch.repeat_interleave(px, S)
    pys = torch.repeat_interleave(py, S)
    sample_ids = sample0 + torch.arange(S, dtype=torch.int32,
                                        device=dev).repeat(P)

    jx, jy = _uniform(threefry.fold_in(key, 1), 2, P * S, dt, dev)
    origin, direction = rays_for_pixels(cam, pxs, pys, jx, jy, sample_ids,
                                        cfg.samples)
    acc = render_rays(scn, meta, cfg, origin, direction,
                      threefry.fold_in(key, 2), route)
    return Vec3(*(a.reshape(P, S).sum(dim=1) for a in acc))


def render_chunks(scn: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
                  cam: CameraArrays, px: torch.Tensor, py: torch.Tensor,
                  c0: int, n: int, key: torch.Tensor,
                  route: IntersectRoute = None) -> Vec3:
    """Sum of the render passes of chunks [c0, c0 + n), each of
    cfg.samples_per_pass samples under fold_in(key, c) (the JAX package's
    _render_tile_jit and its driver's segment_wavefront)."""
    if route is None:
        route = intersect_route(scn, meta, cfg)
    S = cfg.samples_per_pass
    acc = Vec3.zeros((px.shape[0],), cam.inverse.dtype, px.device)
    for c in range(c0, c0 + n):
        acc = acc + render_pass(scn, meta, cfg, cam, px, py, c * S, S,
                                threefry.fold_in(key, c), route)
    return acc


def render(scn: SceneArrays, meta: SceneMeta, camera: Camera,
           cfg: RenderConfig, key: Optional[torch.Tensor] = None,
           route: IntersectRoute = None) -> np.ndarray:
    """Full-image render on the scene's device (its dtype is cfg.dtype's).
    Returns [H, W, 3] float32. Rows go in blocks of cfg.rows_per_pass,
    each under fold_in(key, first row), as in the JAX package's render."""
    dev = scn.color.device
    if key is None:
        key = threefry.prng_key(cfg.seed)
    if route is None:
        route = intersect_route(scn, meta, cfg)
    W, H = camera.width, camera.height
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    cam = camera.pack(dtype, dev)

    spp_chunk = min(cfg.samples_per_pass, cfg.samples)
    cfg = cfg.replace(samples_per_pass=spp_chunk)
    n_chunks = max(1, (cfg.samples + spp_chunk - 1) // spp_chunk)
    total_spp = n_chunks * spp_chunk

    rows = cfg.rows_per_pass or H
    out = np.zeros((H, W, 3), dtype=np.float32)
    for y0 in range(0, H, rows):
        y1 = min(y0 + rows, H)
        px, py = pixel_grid(W, y0, y1, dev)
        tile = render_chunks(scn, meta, cfg, cam, px, py, 0, n_chunks,
                             threefry.fold_in(key, y0), route)
        out[y0:y1] = tile.to_array().cpu().numpy().astype(
            np.float32).reshape(y1 - y0, W, 3)
    return out / float(total_spp)
