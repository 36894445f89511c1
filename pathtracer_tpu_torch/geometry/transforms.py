"""Transform matrix builders.

Behavioral equivalents of the reference's geom/{translation,scaling,rotation}.go
and camera.ViewTransform (internal/app/camera/camera.go:50-81).
"""
from __future__ import annotations

import numpy as np

from . import tuple4


def translate(x: float, y: float, z: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[0, 3] = x
    m[1, 3] = y
    m[2, 3] = z
    return m


def scale(x: float, y: float, z: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[0, 0] = x
    m[1, 1] = y
    m[2, 2] = z
    return m


def rotate_x(r: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    c, s = np.cos(r), np.sin(r)
    m[1, 1] = c
    m[1, 2] = -s
    m[2, 1] = s
    m[2, 2] = c
    return m


def rotate_y(r: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    c, s = np.cos(r), np.sin(r)
    m[0, 0] = c
    m[0, 2] = s
    m[2, 0] = -s
    m[2, 2] = c
    return m


def rotate_z(r: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    c, s = np.cos(r), np.sin(r)
    m[0, 0] = c
    m[0, 1] = -s
    m[1, 0] = s
    m[1, 1] = c
    return m


def shear(xy: float, xz: float, yx: float, yz: float, zx: float, zy: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[0, 1] = xy
    m[0, 2] = xz
    m[1, 0] = yx
    m[1, 2] = yz
    m[2, 0] = zx
    m[2, 1] = zy
    return m


def view_transform(from_p: np.ndarray, to_p: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Look-at view matrix (camera.go:50-81)."""
    forward = tuple4.normalize(tuple4.sub(to_p, from_p))
    up_n = tuple4.normalize(up)
    left = tuple4.cross(forward, up_n)
    true_up = tuple4.cross(left, forward)

    vt = np.eye(4, dtype=np.float64)
    vt[0, :3] = left[:3]
    vt[1, :3] = true_up[:3]
    vt[2, :3] = -forward[:3]
    return vt @ translate(-from_p[0], -from_p[1], -from_p[2])
