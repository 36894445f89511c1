"""4-component tuple math (points w=1, vectors w=0).

Behavioral equivalent of the reference's Tuple4 (internal/app/geom/tuple.go:7-269)
including the AVX2-accelerated Dot/Cross paths (cfiles/DotProduct.c,
cfiles/CrossProduct.c) -- numpy vectorizes these, no intrinsics needed.

All functions accept numpy arrays of shape (..., 4) so the same code serves
scalar host-side use and batched use.
"""
from __future__ import annotations

import numpy as np


def point(x: float, y: float, z: float) -> np.ndarray:
    return np.array([x, y, z, 1.0], dtype=np.float64)


def vector(x: float, y: float, z: float) -> np.ndarray:
    return np.array([x, y, z, 0.0], dtype=np.float64)


def color(r: float, g: float, b: float) -> np.ndarray:
    # Reference colors are Tuple4 with w=0 by convention (geom.NewColor).
    return np.array([r, g, b, 0.0], dtype=np.float64)


def is_point(t: np.ndarray) -> bool:
    return bool(abs(t[..., 3] - 1.0) < 1e-9)


def is_vector(t: np.ndarray) -> bool:
    return bool(abs(t[..., 3]) < 1e-9)


def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a + b


def sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a - b


def negate(a: np.ndarray) -> np.ndarray:
    return -a


def mul_scalar(a: np.ndarray, s: float) -> np.ndarray:
    return a * s


def div_scalar(a: np.ndarray, s: float) -> np.ndarray:
    return a / s


def magnitude(a: np.ndarray) -> np.ndarray:
    return np.sqrt(np.sum(a * a, axis=-1))


def normalize(a: np.ndarray) -> np.ndarray:
    return a / magnitude(a)[..., None]


def dot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, axis=-1)


def cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """3D cross product of the xyz parts; w of the result is 0."""
    out = np.zeros(np.broadcast_shapes(a.shape, b.shape), dtype=np.result_type(a, b))
    out[..., 0] = a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1]
    out[..., 1] = a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2]
    out[..., 2] = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    return out


def hadamard(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a * b


def reflect(v: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Reflect v about normal n (both (..., 4))."""
    return v - n * (2.0 * dot(v, n))[..., None]
