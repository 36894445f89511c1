"""Scene intersection as torch ops: the primitive tests and the stackless
skip-link BVH walk, in SoA [R]-per-component layout (render/vec3.py).

Counterpart of pathtracer_tpu.render.intersect (the JAX package's XLA
walk, which runs outside any Pallas kernel), operation for operation, in
the rays' dtype and on their device: the reference's
findClosestIntersection (tracer.cl:537-742) with the rays transformed into
each object's space by its inverse (tracer.cl:547-548), the plane, sphere,
uncapped cylinder, box and group tests, intersections closer than EPSILON
discarded and t >= t_max a miss (tracer.cl:727-739). The wavefront
integrator takes this walk in f64, on the CPU, and wherever the
intersect-only kernel (megakernel.intersect_batch) does not run.

The object loop is a Python loop over meta.obj_types; the BVH walk keeps
one skip-link node index per ray and runs until every ray has left its
group's node range (one host check a node step).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..scene.pack import SceneArrays, SceneMeta
from ..scene.shapes import BOX, CYLINDER, GROUP, PLANE, SPHERE
from .vec3 import Vec3, mat_apply_point, mat_apply_vector

_INF = float("inf")


class Hit(NamedTuple):
    t: torch.Tensor          # [R] distance; >= t_max means miss
    obj_idx: torch.Tensor    # [R] i32 object slot (clipped valid; check t)
    local_origin: Vec3       # [R] ray origin in the hit object's space
    local_dir: Vec3          # [R] ray direction in the hit object's space
    is_tri: torch.Tensor     # [R] bool: hit a BVH triangle
    tri_slot: torch.Tensor   # [R] i32 triangle slot (-1 none)
    tri_u: torch.Tensor      # [R] barycentric u
    tri_v: torch.Tensor      # [R] barycentric v


def _axis_slab(o, d, mn, mx, eps):
    """One-axis checkAxis (tracer.cl:250-268)."""
    big = 1e30
    use = torch.abs(d) >= eps
    d_safe = torch.where(use, d, torch.ones_like(d))
    t1 = torch.where(use, (mn - o) / d_safe, (mn - o) * big)
    t2 = torch.where(use, (mx - o) / d_safe, (mx - o) * big)
    return torch.minimum(t1, t2), torch.maximum(t1, t2)


def slab_test(o: Vec3, d: Vec3, bb_min: Vec3, bb_max: Vec3, eps
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ray/AABB slab test (tracer.cl:270-280) -> (tmin, tmax)."""
    x1, x2 = _axis_slab(o.x, d.x, bb_min.x, bb_max.x, eps)
    y1, y2 = _axis_slab(o.y, d.y, bb_min.y, bb_max.y, eps)
    z1, z2 = _axis_slab(o.z, d.z, bb_min.z, bb_max.z, eps)
    return (
        torch.maximum(torch.maximum(x1, y1), z1),
        torch.minimum(torch.minimum(x2, y2), z2),
    )


# --- primitive tests: object-space rays -> closest valid t [R] (inf = miss)

def _plane_t(o: Vec3, d: Vec3, eps):
    ok = torch.abs(d.y) > eps
    t = -o.y / torch.where(ok, d.y, torch.ones_like(d.y))
    return torch.where(ok & (t > eps), t, torch.full_like(t, _INF))


def _sphere_t(o: Vec3, d: Vec3, eps):
    """Unit-sphere intersection (tracer.cl:448-476) in the JAX package's
    geometric foot-point form, stable in f32 for strongly anisotropic
    object scales."""
    a = d.dot(d)
    t_mid = -o.dot(d) / a
    m = o + d * t_mid
    perp2 = m.dot(m)
    ok = perp2 < 1.0
    dt = torch.sqrt(torch.where(ok, (1.0 - perp2) / a,
                                torch.zeros_like(a)))
    t1 = t_mid - dt
    t2 = t_mid + dt
    inf = torch.full_like(t1, _INF)
    return torch.minimum(
        torch.where(ok & (t1 > eps), t1, inf),
        torch.where(ok & (t2 > eps), t2, inf),
    )


def _cylinder_t(o: Vec3, d: Vec3, min_y, max_y, eps):
    """Uncapped truncated cylinder (tracer.cl:396-446; the caps are
    disabled in the reference kernel too, tracer.cl:437-444)."""
    a = d.x * d.x + d.z * d.z
    ok_a = torch.abs(a) >= eps
    a_safe = torch.where(ok_a, a, torch.ones_like(a))
    t_mid = -(o.x * d.x + o.z * d.z) / a_safe
    mx = o.x + t_mid * d.x
    mz = o.z + t_mid * d.z
    perp2 = mx * mx + mz * mz
    ok = ok_a & (perp2 <= 1.0)
    dt = torch.sqrt(torch.where(ok, (1.0 - perp2) / a_safe,
                                torch.zeros_like(a)))
    t0 = t_mid - dt
    t1 = t_mid + dt
    y0 = o.y + t0 * d.y
    y1 = o.y + t1 * d.y
    v0 = ok & (y0 > min_y) & (y0 < max_y) & (t0 > eps)
    v1 = ok & (y1 > min_y) & (y1 < max_y) & (t1 > eps)
    inf = torch.full_like(t0, _INF)
    return torch.minimum(torch.where(v0, t0, inf), torch.where(v1, t1, inf))


def _box_t(o: Vec3, d: Vec3, eps):
    one = Vec3.full(o.x.shape, 1.0, 1.0, 1.0, o.x.dtype, o.x.device)
    tmin, tmax = slab_test(o, d, -1.0 * one, one, eps)
    ok = tmin <= tmax
    inf = torch.full_like(tmin, _INF)
    t_near = torch.where(ok & (tmin > eps), tmin, inf)
    t_far = torch.where(ok & (tmax > eps), tmax, inf)
    return torch.minimum(t_near, t_far)


# --- BVH traversal ------------------------------------------------------------

def _triangle_test(scn: SceneArrays, slot: torch.Tensor, o: Vec3, d: Vec3,
                   eps):
    """Moller-Trumbore (tracer.cl:640-674) of the object-space rays (o, d)
    against triangle slot `slot` [R] (clamped into the pool, as the JAX
    gathers clamp): (det_ok, u, v, t), unfiltered."""
    si = torch.clamp(slot, 0, scn.tri_p1.shape[0] - 1).long()
    p1 = Vec3(*(scn.tri_p1[si, c] for c in range(3)))
    e1 = Vec3(*(scn.tri_e1[si, c] for c in range(3)))
    e2 = Vec3(*(scn.tri_e2[si, c] for c in range(3)))
    dc2 = d.cross(e2)
    det = e1.dot(dc2)
    det_ok = torch.abs(det) >= eps
    f = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    p1o = o - p1
    u = f * p1o.dot(dc2)
    oc1 = p1o.cross(e1)
    v = f * d.dot(oc1)
    t = f * e2.dot(oc1)
    return det_ok, u, v, t


class _TravState(NamedTuple):
    idx: torch.Tensor        # [R] current node
    best_t: torch.Tensor     # [R]
    best_slot: torch.Tensor  # [R] triangle slot of the best hit (-1 none)
    best_u: torch.Tensor
    best_v: torch.Tensor


def traverse_bvh(scn: SceneArrays, o: Vec3, d: Vec3, root: int, end: int,
                 leaf_size: int, eps: float, t_max: float) -> _TravState:
    """Stackless skip-link walk over nodes [root, end) with object-space
    rays (o, d); the leaf's LEAF_SIZE slots are tested one [R] gather at
    a time with a running minimum. Replaces the reference's per-ray
    explicit stack (tracer.cl:624-718)."""
    n_nodes = scn.node_bb_min.shape[0]
    R = o.x.shape[0]
    dt = o.x.dtype
    dev = o.x.device
    s = _TravState(
        idx=torch.full((R,), root, dtype=torch.int32, device=dev),
        best_t=torch.full((R,), _INF, dtype=dt, device=dev),
        best_slot=torch.full((R,), -1, dtype=torch.int32, device=dev),
        best_u=torch.zeros((R,), dtype=dt, device=dev),
        best_v=torch.zeros((R,), dtype=dt, device=dev),
    )

    while bool((s.idx < end).any()):
        active = s.idx < end
        ni = torch.clamp(s.idx, 0, n_nodes - 1).long()
        bb_min = Vec3(*(scn.node_bb_min[ni, k] for k in range(3)))
        bb_max = Vec3(*(scn.node_bb_max[ni, k] for k in range(3)))
        tmin, tmax = slab_test(o, d, bb_min, bb_max, eps)
        # (tmax > eps) and (tmin < best_t): a box wholly behind the ray, or
        # entered beyond the current best hit, holds no closer hit
        hit_box = active & (tmin < tmax) & (tmax > eps) & (tmin < s.best_t)
        is_leaf = scn.node_is_leaf[ni] == 1
        do_tri = hit_box & is_leaf
        start = scn.node_tri_start[ni]

        best_t, best_slot = s.best_t, s.best_slot
        best_u, best_v = s.best_u, s.best_v
        for k in range(leaf_size):
            slot = start + k
            # an inner node's slots are garbage and masked by do_tri; the
            # gathers clamp them as the JAX gathers do
            det_ok, u, v, t = _triangle_test(scn, slot, o, d, eps)
            valid = (do_tri & det_ok
                     & (u >= 0.0) & (u <= 1.0)
                     & (v >= 0.0) & (u + v <= 1.0)
                     & (t > eps) & (t < t_max))
            better = valid & (t < best_t)
            best_t = torch.where(better, t, best_t)
            best_slot = torch.where(better, slot, best_slot)
            best_u = torch.where(better, u, best_u)
            best_v = torch.where(better, v, best_v)

        s = _TravState(
            idx=torch.where(active,
                            torch.where(hit_box, s.idx + 1,
                                        scn.node_exit[ni]),
                            s.idx),
            best_t=best_t, best_slot=best_slot, best_u=best_u,
            best_v=best_v)
    return s


# --- whole-scene intersection -----------------------------------------------

def intersect_scene(scn: SceneArrays, meta: SceneMeta, origin: Vec3,
                    direction: Vec3, eps: float, t_max: float) -> Hit:
    """Nearest hit of world rays over every object of the scene."""
    R = origin.x.shape[0]
    dt = origin.x.dtype
    dev = origin.x.device

    best_t = torch.full((R,), _INF, dtype=dt, device=dev)
    best_obj = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_lo, best_ld = origin, direction
    is_tri = torch.zeros((R,), dtype=torch.bool, device=dev)
    tri_slot = torch.full((R,), -1, dtype=torch.int32, device=dev)
    tri_u = torch.zeros((R,), dtype=dt, device=dev)
    tri_v = torch.zeros((R,), dtype=dt, device=dev)

    group_bvh = {g: (r, e) for g, r, e in meta.group_bvh}
    for j, code in enumerate(meta.obj_types):
        if code not in (PLANE, SPHERE, CYLINDER, BOX, GROUP):
            continue
        inv = scn.inverse[j]
        to = mat_apply_point(inv, origin)
        td = mat_apply_vector(inv, direction)

        tri_here = False
        if code == PLANE:
            t_j = _plane_t(to, td, eps)
        elif code == SPHERE:
            t_j = _sphere_t(to, td, eps)
        elif code == CYLINDER:
            t_j = _cylinder_t(to, td, scn.min_y[j], scn.max_y[j], eps)
        elif code == BOX:
            t_j = _box_t(to, td, eps)
        else:  # GROUP
            root, end = group_bvh[j]
            st = traverse_bvh(scn, to, td, root, end, meta.leaf_size, eps,
                              t_max)
            t_j = st.best_t
            tri_here = True

        closer = t_j < best_t
        best_t = torch.where(closer, t_j, best_t)
        best_obj = torch.where(closer, j, best_obj)
        best_lo = Vec3.where(closer, to, best_lo)
        best_ld = Vec3.where(closer, td, best_ld)
        if tri_here:
            is_tri = closer | is_tri
            tri_slot = torch.where(closer, st.best_slot, tri_slot)
            tri_u = torch.where(closer, st.best_u, tri_u)
            tri_v = torch.where(closer, st.best_v, tri_v)
        else:
            is_tri = ~closer & is_tri

    return Hit(
        t=torch.clamp(best_t, max=t_max),
        obj_idx=torch.clamp(best_obj, min=0),
        local_origin=best_lo,
        local_dir=best_ld,
        is_tri=is_tri,
        tri_slot=tri_slot,
        tri_u=tri_u,
        tri_v=tri_v,
    )


# --- re-attaching a winner found elsewhere ------------------------------------

def reattach_hit(scn: SceneArrays, meta: SceneMeta, origin: Vec3,
                 direction: Vec3, obj_idx: torch.Tensor,
                 tri_slot: torch.Tensor, t: torch.Tensor, eps: float,
                 t_max: float) -> Hit:
    """The Hit of intersect_scene for world rays whose winner is already
    known (obj_idx, tri_slot: -1 off a triangle, and t: at least t_max on a
    miss, as the intersect kernel returns them), recomputed by the walk's
    own operations for that winner alone: its object-space ray, its test's
    t and, on a triangle, the barycentrics. So where origin or direction
    carry a gradient, t, the local ray and (u, v) carry the walk's: the
    derivative of a nearest hit is that of its winner's branch. A miss
    keeps `t` (detached: the walk's is the constant t_max) and the world
    ray; a winner whose recomputed t is not finite keeps `t` (detached) at
    its object-space ray. Counts its calls and rays in reattach_hit.calls
    and .rays."""
    R = origin.x.shape[0]
    won = t < t_max
    oi = obj_idx.long()
    # per-ray 4x4 inverses as [4, 4, R]: m[i, j] is an [R] stream, so
    # mat_apply_* run the walk's products and sums in the walk's order
    inv = scn.inverse[oi].permute(1, 2, 0)
    to = mat_apply_point(inv, origin)
    td = mat_apply_vector(inv, direction)
    code = scn.obj_type[oi]
    inf = torch.full_like(to.x, _INF)
    t_re = inf
    is_tri = won & (tri_slot >= 0)
    tri_u = torch.zeros_like(t_re)
    tri_v = torch.zeros_like(t_re)
    for c in sorted(set(meta.obj_types)):
        if c == PLANE:
            t_c = _plane_t(to, td, eps)
        elif c == SPHERE:
            t_c = _sphere_t(to, td, eps)
        elif c == CYLINDER:
            t_c = _cylinder_t(to, td, scn.min_y[oi], scn.max_y[oi], eps)
        elif c == BOX:
            t_c = _box_t(to, td, eps)
        elif c == GROUP:
            _, u, v, t_c = _triangle_test(scn, tri_slot, to, td, eps)
            tri_u = torch.where(is_tri, u, tri_u)
            tri_v = torch.where(is_tri, v, tri_v)
            t_c = torch.where(is_tri, t_c, inf)
        else:
            continue
        t_re = torch.where(code == c, t_c, t_re)
    keep = won & torch.isfinite(t_re)
    reattach_hit.calls += 1
    reattach_hit.rays += R
    return Hit(
        t=torch.where(keep, torch.clamp(t_re, max=t_max), t.detach()),
        obj_idx=obj_idx,
        local_origin=Vec3.where(won, to, origin),
        local_dir=Vec3.where(won, td, direction),
        is_tri=is_tri,
        tri_slot=tri_slot,
        tri_u=tri_u,
        tri_v=tri_v,
    )


reattach_hit.calls = 0
reattach_hit.rays = 0
