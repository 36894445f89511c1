"""Sampling and reflection/refraction math (SoA Vec3 forms).

Counterpart of pathtracer_tpu.render.sampling, operation for operation:
the sunflower aperture points (tracer.cl:221-248), randomVectorInHemisphere
(tracer.cl:348-366), randomPointOnSphere (tracer.cl:321-336), schlick
(tracer.cl:485-505) and computeRefractedRay (tracer.cl:507-533). The
uniforms come from the caller (render/threefry.py on the wavefront path).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .vec3 import Vec3

_GOLDEN = (math.sqrt(5.0) + 1.0) / 2.0


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    """v (a number or tensor) as a tensor of ref's dtype and device."""
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def sunflower(amount_points: int, alpha: float, point_number: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evenly distribute points in a unit disc (tracer.cl:235-248); the
    randomize=false path only, the reference's (tracer.cl:766)."""
    n = _like(float(amount_points), point_number)
    b = torch.round(alpha * torch.sqrt(n))  # boundary point count
    r = torch.where(
        point_number <= (n - b),
        torch.sqrt(torch.clamp(point_number - 0.5, min=0.0))
        / torch.sqrt(n - (b + 1.0) / 2.0),
        _like(1.0, point_number),
    )
    phi2 = _GOLDEN * _GOLDEN
    theta = 2.0 * math.pi * point_number / phi2
    return r * torch.cos(theta), r * torch.sin(theta)


def random_vector_in_hemisphere(normal: Vec3, u1: torch.Tensor,
                                u2: torch.Tensor) -> Vec3:
    """Cosine-ish-weighted hemisphere direction about `normal`
    (tracer.cl:348-366)."""
    rand1 = 2.0 * math.pi * u1
    rand2s = torch.sqrt(u2)

    # axis = |n.x| > 0.1 ? (0,1,0) : (1,0,0)  (tracer.cl:355-359)
    pick = torch.abs(normal.x) > 0.1
    zero = torch.zeros_like(normal.x)
    one = torch.ones_like(normal.x)
    axis = Vec3(torch.where(pick, zero, one), torch.where(pick, one, zero),
                zero)
    u = axis.cross(normal).normalized()
    v = normal.cross(u)
    cu = torch.cos(rand1) * rand2s
    cv = torch.sin(rand1) * rand2s
    cn = torch.sqrt(1.0 - u2)
    return Vec3(
        u.x * cu + v.x * cv + normal.x * cn,
        u.y * cu + v.y * cv + normal.y * cn,
        u.z * cu + v.z * cv + normal.z * cn,
    )


def random_point_on_sphere(r: float, u1: torch.Tensor,
                           u2: torch.Tensor) -> Vec3:
    """The reference's randomPointOnSphere (tracer.cl:321-336), with its
    latitude offset (used only by NEE)."""
    lat = torch.arccos(2.0 * u1 - 1.0) - math.pi * 2.0
    lon = 2.0 * math.pi * u2
    return Vec3(
        torch.cos(lat) * torch.cos(lon) * r,
        (torch.sin(lat) - math.pi * 0.25) * r,
        torch.cos(lat) * torch.sin(lon) * r,
    )


def _pow5(x: torch.Tensor) -> torch.Tensor:
    """x ** 5 as XLA's integer_pow computes it: x * ((x*x) * (x*x))."""
    x2 = x * x
    return x * (x2 * x2)


def _sqrt0(x: torch.Tensor) -> torch.Tensor:
    """sqrt of x >= 0, the same values, with the derivative at 0 taken as 0
    (not inf). Where the refraction terms below are not used (a ray that
    reflects, or a surface of index 1 at a grazing angle, where 1 - sin2t
    rounds to 0), autograd multiplies sqrt's infinite derivative by the
    unused branch's zero cotangent: NaN, which then reaches the
    parameters. The JAX package's sqrt has that fault (its texel gradients
    on `textures` hold NaN; tests/test_torch_wavefront_grad.py)."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def schlick(eye_vec: Vec3, normal_vec: Vec3, n1, n2) -> torch.Tensor:
    """Schlick reflectance approximation (tracer.cl:485-505)."""
    n1 = _like(n1, eye_vec.x)
    n2 = _like(n2, eye_vec.x)
    cos = eye_vec.dot(normal_vec)

    n = n1 / n2
    sin2t = (n * n) * (1.0 - cos * cos)
    tir = (n1 > n2) & (sin2t > 1.0)
    cos_t = _sqrt0(torch.clamp(1.0 - sin2t, min=0.0))
    cos_eff = torch.where(n1 > n2, cos_t, cos)

    temp = (n1 - n2) / (n1 + n2)
    r0 = temp * temp
    res = r0 + (1.0 - r0) * _pow5(1.0 - cos_eff)
    return torch.where(tir, _like(1.0, res), res)


def refracted_direction(eye_vec: Vec3, normal_vec: Vec3, n1, n2) -> Vec3:
    """Refracted ray direction (tracer.cl:507-533); the zero vector on
    total internal reflection (which the callers' schlick roulette never
    reaches: TIR implies schlick() == 1)."""
    cos_i = eye_vec.dot(normal_vec)
    ratio = torch.broadcast_to(
        _like(n1, cos_i) / _like(n2, cos_i), cos_i.shape)
    sin2t = (ratio * ratio) * (1.0 - cos_i * cos_i)
    cos_t = _sqrt0(torch.clamp(1.0 - sin2t, min=0.0))
    k = ratio * cos_i - cos_t
    ok = sin2t <= 1.0
    zero = torch.zeros_like(cos_i)
    return Vec3(
        torch.where(ok, normal_vec.x * k - eye_vec.x * ratio, zero),
        torch.where(ok, normal_vec.y * k - eye_vec.y * ratio, zero),
        torch.where(ok, normal_vec.z * k - eye_vec.z * ratio, zero),
    )
