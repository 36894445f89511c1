"""SoA 3-vectors: three separate [R] tensors.

Counterpart of pathtracer_tpu.render.vec3. The wavefront integrator keeps
every per-ray quantity as one dense [R] tensor per component, on the
tensors' device and in their dtype (f32 or f64); each method computes in
the JAX package's operation order, so the two agree op for op.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- arithmetic ----------------------------------------------------
    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, s) -> "Vec3":
        if isinstance(s, Vec3):  # hadamard
            return Vec3(self.x * s.x, self.y * s.y, self.z * s.z)
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def norm(self) -> torch.Tensor:
        return torch.sqrt(self.dot(self))

    def normalized(self) -> "Vec3":
        inv = 1.0 / self.norm()
        return Vec3(self.x * inv, self.y * inv, self.z * inv)

    def reflect(self, n: "Vec3") -> "Vec3":
        """self - n * 2*dot(self, n) (tracer.cl:985-987)."""
        d = 2.0 * self.dot(n)
        return Vec3(self.x - n.x * d, self.y - n.y * d, self.z - n.z * d)

    def abs(self) -> "Vec3":
        return Vec3(torch.abs(self.x), torch.abs(self.y), torch.abs(self.z))

    def max_component(self) -> torch.Tensor:
        return torch.maximum(torch.maximum(self.x, self.y), self.z)

    def min_component(self) -> torch.Tensor:
        return torch.minimum(torch.minimum(self.x, self.y), self.z)

    # -- selection / construction ---------------------------------------
    @staticmethod
    def where(mask, a: "Vec3", b: "Vec3") -> "Vec3":
        return Vec3(
            torch.where(mask, a.x, b.x),
            torch.where(mask, a.y, b.y),
            torch.where(mask, a.z, b.z),
        )

    @staticmethod
    def full(shape, x: float, y: float, z: float, dtype=torch.float32,
             device=None) -> "Vec3":
        return Vec3(
            torch.full(shape, x, dtype=dtype, device=device),
            torch.full(shape, y, dtype=dtype, device=device),
            torch.full(shape, z, dtype=dtype, device=device),
        )

    @staticmethod
    def zeros(shape, dtype=torch.float32, device=None) -> "Vec3":
        z = torch.zeros(shape, dtype=dtype, device=device)
        return Vec3(z, z, z)

    @staticmethod
    def from_array(a: torch.Tensor) -> "Vec3":
        """[..., 3] -> Vec3 of [...]."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z], dim=-1)


def mat_apply_point(m: torch.Tensor, p: Vec3) -> Vec3:
    """Apply one 4x4 matrix (its elements broadcast as 0-d tensors) to a
    Vec3 point."""
    return Vec3(
        m[0, 0] * p.x + m[0, 1] * p.y + m[0, 2] * p.z + m[0, 3],
        m[1, 0] * p.x + m[1, 1] * p.y + m[1, 2] * p.z + m[1, 3],
        m[2, 0] * p.x + m[2, 1] * p.y + m[2, 2] * p.z + m[2, 3],
    )


def mat_apply_vector(m: torch.Tensor, v: Vec3) -> Vec3:
    return Vec3(
        m[0, 0] * v.x + m[0, 1] * v.y + m[0, 2] * v.z,
        m[1, 0] * v.x + m[1, 1] * v.y + m[1, 2] * v.z,
        m[2, 0] * v.x + m[2, 1] * v.y + m[2, 2] * v.z,
    )


def mat_gather_apply_point(m_cols: torch.Tensor, oi: torch.Tensor,
                           p: Vec3) -> Vec3:
    """Apply per-ray-selected matrices stored as [No, 12] row-major (3x4
    affine) by gathering 12 [R] scalar streams."""
    def g(k):
        return m_cols[oi, k]
    return Vec3(
        g(0) * p.x + g(1) * p.y + g(2) * p.z + g(3),
        g(4) * p.x + g(5) * p.y + g(6) * p.z + g(7),
        g(8) * p.x + g(9) * p.y + g(10) * p.z + g(11),
    )


def mat_gather_apply_vector(m_cols: torch.Tensor, oi: torch.Tensor,
                            v: Vec3) -> Vec3:
    def g(k):
        return m_cols[oi, k]
    return Vec3(
        g(0) * v.x + g(1) * v.y + g(2) * v.z,
        g(4) * v.x + g(5) * v.y + g(6) * v.z,
        g(8) * v.x + g(9) * v.y + g(10) * v.z,
    )
