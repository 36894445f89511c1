"""The reference of the inverse-rendering step: the wavefront integrator's
fixed-trip bounce loop, differentiated by autograd with respect to the
object colors, its image loss, and Adam.

Frozen copy, cut to scenes of primitives without textures or next-event
estimation, of `render_pass`, `render_rays`, `bounce_step`,
`_surface_normal` and `_fetch_object_attrs` of
pathtracer_tpu_torch/render/integrator.py, `rays_for_pixels` of
render/camera.py, `schlick`, `refracted_direction` and
`random_vector_in_hemisphere` of render/sampling.py, and `image_loss` of
diff/grad.py, at commit 7dc6265, with the same float32 operations in the
same order. The nearest hit is the reference's own object loop
(trace.nearest_hit, the semantics of the program's intersect kernel),
with no gradient through it, as the program's route has none on these
scenes. `dtype` runs the paths in another precision (the check's
control).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import threefry, trace
from .scene import TYPES, RefScene

PLANE, SPHERE, CYLINDER, BOX = (TYPES[k] for k in
                                ("plane", "sphere", "cylinder", "box"))


class V(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        return V(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self):
        return V(-self.x, -self.y, -self.z)

    def __mul__(self, s):
        if isinstance(s, V):
            return V(self.x * s.x, self.y * s.y, self.z * s.z)
        return V(self.x * s, self.y * s, self.z * s)

    def dot(self, o):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o):
        return V(self.y * o.z - self.z * o.y, self.z * o.x - self.x * o.z,
                 self.x * o.y - self.y * o.x)

    def normalized(self):
        inv = 1.0 / torch.sqrt(self.dot(self))
        return V(self.x * inv, self.y * inv, self.z * inv)

    def reflect(self, n):
        d = 2.0 * self.dot(n)
        return V(self.x - n.x * d, self.y - n.y * d, self.z - n.z * d)


def where(m, a: V, b: V) -> V:
    return V(torch.where(m, a.x, b.x), torch.where(m, a.y, b.y),
             torch.where(m, a.z, b.z))


def _like(v, ref):
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def _sqrt0(x):
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _schlick(eye: V, normal: V, n1, n2):
    n1 = _like(n1, eye.x)
    n2 = _like(n2, eye.x)
    cos = eye.dot(normal)
    n = n1 / n2
    sin2t = (n * n) * (1.0 - cos * cos)
    tir = (n1 > n2) & (sin2t > 1.0)
    cos_t = _sqrt0(torch.clamp(1.0 - sin2t, min=0.0))
    cos_eff = torch.where(n1 > n2, cos_t, cos)
    temp = (n1 - n2) / (n1 + n2)
    r0 = temp * temp
    x = 1.0 - cos_eff
    x2 = x * x
    res = r0 + (1.0 - r0) * (x * (x2 * x2))
    return torch.where(tir, _like(1.0, res), res)


def _refracted(eye: V, normal: V, n1, n2) -> V:
    cos_i = eye.dot(normal)
    ratio = torch.broadcast_to(_like(n1, cos_i) / _like(n2, cos_i),
                               cos_i.shape)
    sin2t = (ratio * ratio) * (1.0 - cos_i * cos_i)
    cos_t = _sqrt0(torch.clamp(1.0 - sin2t, min=0.0))
    k = ratio * cos_i - cos_t
    ok = sin2t <= 1.0
    zero = torch.zeros_like(cos_i)
    return V(torch.where(ok, normal.x * k - eye.x * ratio, zero),
             torch.where(ok, normal.y * k - eye.y * ratio, zero),
             torch.where(ok, normal.z * k - eye.z * ratio, zero))


def _hemisphere(normal: V, u1, u2) -> V:
    rand1 = 2.0 * math.pi * u1
    rand2s = torch.sqrt(u2)
    pick = torch.abs(normal.x) > 0.1
    zero = torch.zeros_like(normal.x)
    one = torch.ones_like(normal.x)
    axis = V(torch.where(pick, zero, one), torch.where(pick, one, zero), zero)
    u = axis.cross(normal).normalized()
    v = normal.cross(u)
    cu = torch.cos(rand1) * rand2s
    cv = torch.sin(rand1) * rand2s
    cn = torch.sqrt(1.0 - u2)
    return V(u.x * cu + v.x * cv + normal.x * cn,
             u.y * cu + v.y * cv + normal.y * cn,
             u.z * cu + v.z * cv + normal.z * cn)


def camera(sc: RefScene, dtype, device):
    """The camera as the wavefront takes it: the 4x4 inverse view and
    0-d pixel size and half extents."""
    c = sc.cam
    inv = torch.zeros(4, 4, dtype=torch.float64)
    inv[:3, :] = torch.tensor(c[0:12], dtype=torch.float64).reshape(3, 4)
    inv[3, 3] = 1.0
    return (inv.to(dtype).to(device),
            *(torch.tensor(v, dtype=dtype, device=device) for v in c[12:15]))


def _apply_point(m, x, y, z) -> V:
    return V(m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3],
             m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3],
             m[2, 0] * x + m[2, 1] * y + m[2, 2] * z + m[2, 3])


def _bounce(sc: RefScene, render: dict, st: dict, key, color, emission):
    eps, t_max = render["epsilon"], render["t_max"]
    o, d = st["origin"], st["direction"]
    R = o.x.shape[0]
    dt = o.x.dtype
    dev = o.x.device
    rays = [a.detach() for a in (*o, *d)]
    best_t, w, loc, *_ = trace.nearest_hit(
        sc, eps, t_max, *rays, torch.ones(R, dtype=torch.bool, device=dev))
    t = torch.clamp(best_t, max=t_max).to(dt)
    lo = V(*(a.to(dt) for a in loc[:3]))
    ld = V(*(a.to(dt) for a in loc[3:]))
    hit_ok = t < t_max
    obj = sc.obj_table.to(dt)
    trained = torch.index_select(torch.cat([color.T, emission.T], dim=0), 1,
                                 w)
    rows = obj[w]
    types = torch.tensor(sc.types, dtype=dt, device=dev)[w]
    at_color = V(trained[0], trained[1], trained[2])
    at_emission = V(trained[3], trained[4], trained[5])
    refr, refl = rows[:, 30], rows[:, 31]
    min_y, max_y = rows[:, 32], rows[:, 33]
    inv_t = [rows[:, 12 + k] for k in range(12)]

    position = o + d * t
    eye = -d
    lp = lo + ld * t
    zero = torch.zeros_like(lp.x)
    one_r = torch.ones_like(zero)
    n_plane = V(zero, one_r, zero)
    dist = lp.x * lp.x + lp.z * lp.z
    top = (dist < 1.0) & (lp.y >= max_y - eps)
    bottom = (dist < 1.0) & (lp.y <= min_y + eps)
    n_cyl = where(top, V(zero, one_r, zero),
                  where(bottom, V(zero, -one_r, zero), V(lp.x, zero, lp.z)))
    a = V(torch.abs(lp.x), torch.abs(lp.y), torch.abs(lp.z))
    maxc = torch.maximum(torch.maximum(a.x, a.y), a.z)
    sel_x = maxc == a.x
    sel_y = (~sel_x) & (maxc == a.y)
    n_box = where(sel_x, V(lp.x, zero, zero),
                  where(sel_y, V(zero, lp.y, zero), V(zero, zero, lp.z)))
    tri_normal = V(zero, zero, zero)
    n_local = where(types == PLANE, n_plane,
                    where(types == SPHERE, lp,
                          where(types == CYLINDER, n_cyl,
                                where(types == BOX, n_box, tri_normal))))
    normal = V(inv_t[0] * n_local.x + inv_t[1] * n_local.y
               + inv_t[2] * n_local.z,
               inv_t[4] * n_local.x + inv_t[5] * n_local.y
               + inv_t[6] * n_local.z,
               inv_t[8] * n_local.x + inv_t[9] * n_local.y
               + inv_t[10] * n_local.z).normalized()
    normal = where(eye.dot(normal) < 0.0, -normal, normal)
    over = position + normal * eps
    under = position - normal * eps
    u_refl, u_schl, u1, u2 = threefry.uniform(key, (4, R), dev).to(dt)
    one = torch.ones((), dtype=dt, device=dev)

    do_reflect = (refl != 0.0) & (u_refl < refl)
    thin = (~do_reflect) & (refr == -1.0)
    sch_thin = _schlick(eye, normal, 1.0, 1.5)
    thin_pass = thin & (sch_thin < u_schl)
    thin_reflect = thin & ~(sch_thin < u_schl)
    solid = (~do_reflect) & (~thin) & (refr != 1.0)
    inside = st["inside"]
    outside = ~inside
    sch = torch.where(outside, _schlick(eye, normal, one, refr),
                      _schlick(eye, normal, refr, one))
    do_refract = solid & (sch < u_schl)
    refract_dir = where(outside, _refracted(eye, normal, one, refr),
                        _refracted(eye, normal, refr, one))
    solid_reflect = solid & ~do_refract
    diffuse = (~do_reflect) & (~thin) & (~solid)
    hemi = _hemisphere(normal, u1, u2)
    reflect_dir = d.reflect(normal)
    any_reflect = do_reflect | thin_reflect | solid_reflect
    new_dir = where(any_reflect, reflect_dir,
                    where(thin_pass, d, where(do_refract, refract_dir, hemi)))
    cos = torch.where(diffuse, hemi.dot(normal), one)
    new_origin = where(thin_pass | do_refract, under, over)
    is_refraction = (do_refract & outside) | (do_refract & inside)
    new_inside = torch.where(do_refract, outside, inside)

    zc = torch.zeros_like(at_color.x)
    zeros = V(zc, zc, zc)
    col = at_color
    emi = at_emission
    rec = st["alive"] & hit_ok
    no_refr = rec & ~is_refraction
    is_light = emi.x > 0.0
    accum = st["accum"] + where(no_refr, st["mask"] * emi, zeros)
    direct = no_refr & is_light & (st["n_hits"] == 0)
    accum = where(direct, col, accum)
    mask = where(no_refr & ~is_light, st["mask"] * col * cos, st["mask"])
    eff = st["eff"] + (rec & ~is_refraction & ~any_reflect).to(torch.int32)
    n_hits = st["n_hits"] + rec.to(torch.int32)
    alive = (st["alive"] & hit_ok & ~(rec & is_light)
             & (eff < render["max_effective_bounces"]))
    return dict(origin=where(rec, new_origin, o),
                direction=where(rec, new_dir, d), mask=mask, accum=accum,
                alive=alive, inside=torch.where(rec, new_inside, inside),
                n_hits=n_hits, eff=eff)


def render_image(sc: RefScene, render: dict, color, emission, px, py, key,
                 n_samples: int, total_samples: int, dtype=torch.float32):
    """The differentiable estimate of pixels (px, py) at n_samples under
    the threefry key `key`: a V of [P], the mean of the samples."""
    dev = px.device
    P, S = px.shape[0], n_samples
    inv, pixel_size, half_w, half_h = camera(sc, dtype, dev)
    pxs = torch.repeat_interleave(px, S)
    pys = torch.repeat_interleave(py, S)
    R = P * S
    jx, jy = threefry.uniform(threefry.fold_in(key, 1), (2, R), dev).to(
        dtype)
    x_off = pixel_size * (pxs.to(dtype) + jx)
    y_off = pixel_size * (pys.to(dtype) + jy)
    pixel = _apply_point(inv, half_w - x_off, half_h - y_off,
                         -torch.ones_like(x_off))
    zero = torch.zeros_like(x_off)
    origin = _apply_point(inv, zero, zero, zero)
    direction = (pixel - origin).normalized()
    st = dict(origin=origin, direction=direction,
              mask=V(*(torch.full((R,), 1.0, dtype=dtype, device=dev)
                       for _ in range(3))),
              accum=V(*(torch.zeros(R, dtype=dtype, device=dev)
                        for _ in range(3))),
              alive=torch.ones(R, dtype=torch.bool, device=dev),
              inside=torch.zeros(R, dtype=torch.bool, device=dev),
              n_hits=torch.zeros(R, dtype=torch.int32, device=dev),
              eff=torch.zeros(R, dtype=torch.int32, device=dev))
    k2 = threefry.fold_in(key, 2)
    for b in range(render["max_bounces"]):
        st = _bounce(sc, render, st, threefry.fold_in(k2, b), color,
                     emission)
    acc = V(*(a.reshape(P, S).sum(dim=1) for a in st["accum"]))
    return acc * (1.0 / float(n_samples))


def image_loss(img: V, target: V):
    d = img - target
    return torch.mean(d.x * d.x + d.y * d.y + d.z * d.z) / 3.0


def adam(param, grad, state: dict, lr: float, betas=(0.9, 0.999),
         eps: float = 1e-8):
    """One step of Adam (Kingma and Ba, with bias correction; the defaults
    of torch.optim.Adam), in place on `param`; `state` keeps step,
    exp_avg and exp_avg_sq."""
    b1, b2 = betas
    if not state:
        state.update(step=0, exp_avg=torch.zeros_like(param),
                     exp_avg_sq=torch.zeros_like(param))
    state["step"] += 1
    state["exp_avg"] = state["exp_avg"] * b1 + grad * (1.0 - b1)
    state["exp_avg_sq"] = state["exp_avg_sq"] * b2 + grad * grad * (1.0 - b2)
    c1 = 1.0 - b1 ** state["step"]
    c2 = 1.0 - b2 ** state["step"]
    denom = torch.sqrt(state["exp_avg_sq"]) / math.sqrt(c2) + eps
    param -= (lr / c1) * state["exp_avg"] / denom
