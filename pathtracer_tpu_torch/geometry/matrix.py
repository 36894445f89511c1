"""4x4 (and 3x3/2x2) matrix math.

Behavioral equivalent of the reference's Mat4x4 (internal/app/geom/matrix.go:
multiply, transpose, cofactor-expansion determinant and inverse, matrix.go:200).
Matrices are numpy (4, 4) float64 row-major arrays; the reference stores them
as flat [16]float64 row-major, so reference index i maps to [i // 4, i % 4].
"""
from __future__ import annotations

import numpy as np


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def from_flat(elems) -> np.ndarray:
    return np.asarray(elems, dtype=np.float64).reshape(4, 4)


def multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a @ b


def multiply_tuple(m: np.ndarray, t: np.ndarray) -> np.ndarray:
    """m @ t for a (4,4) matrix and (...,4) tuple(s)."""
    return np.einsum("ij,...j->...i", m, t)


def transpose(m: np.ndarray) -> np.ndarray:
    return m.T.copy()


def submatrix(m: np.ndarray, row: int, col: int) -> np.ndarray:
    return np.delete(np.delete(m, row, axis=0), col, axis=1)


def determinant(m: np.ndarray) -> float:
    """Cofactor-expansion determinant, any square size (matrix.go determinant)."""
    n = m.shape[0]
    if n == 2:
        return float(m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0])
    det = 0.0
    for c in range(n):
        det += m[0, c] * cofactor(m, 0, c)
    return float(det)


def minor(m: np.ndarray, row: int, col: int) -> float:
    return determinant(submatrix(m, row, col))


def cofactor(m: np.ndarray, row: int, col: int) -> float:
    sign = -1.0 if (row + col) % 2 else 1.0
    return sign * minor(m, row, col)


def inverse(m: np.ndarray) -> np.ndarray:
    """Inverse via numpy (host-side only; computed once per shape at scene
    build like the reference's SetTransform, sphere.go:60-64)."""
    return np.linalg.inv(m)
