"""Host-side ray type (counterpart of pathtracer_tpu.geometry.ray;
reference: internal/app/geom/ray.go:10-18, internal/app/tracer/
ray.go:9-24)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .matrix import multiply_tuple


class Ray(NamedTuple):
    origin: np.ndarray     # (..., 4) point
    direction: np.ndarray  # (..., 4) vector


def ray_position(ray: Ray, t: float) -> np.ndarray:
    """Point along the ray at distance t (tracer/ray.go Position)."""
    return ray.origin + ray.direction * t


def transform_ray(m: np.ndarray, ray: Ray) -> Ray:
    """Transform both origin and direction by a 4x4 matrix
    (tracer/ray.go TransformRay)."""
    return Ray(multiply_tuple(m, ray.origin), multiply_tuple(m, ray.direction))
