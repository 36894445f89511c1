"""Camera: fov -> half-extents/pixel size and the look-at view transform
(reference camera.NewCamera, camera/camera.go:21-48), and the wavefront's
batched primary-ray generator with AA jitter and sunflower-aperture depth
of field (tracer.cl:745-779).

Counterpart of pathtracer_tpu.render.camera. The megakernel takes the
camera as a flat vector (megakernel.build_camera_vec); the wavefront path
takes `CameraArrays` (Camera.pack) and `rays_for_pixels`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..geometry import matrix as gm
from ..geometry import transforms as gx
from .sampling import sunflower
from .vec3 import Vec3, mat_apply_point


class Camera:
    """Host-side camera (camera/camera.go:8-48)."""

    def __init__(self, width: int, height: int, fov: float,
                 from_p: np.ndarray, look_at: np.ndarray,
                 aperture: float = 0.0, focal_length: float = 0.0):
        half_view = math.tan(fov / 2.0)
        aspect = width / height
        if aspect >= 1.0:
            half_width, half_height = half_view, half_view / aspect
        else:
            half_width, half_height = half_view * aspect, half_view
        self.width = width
        self.height = height
        self.fov = fov
        self.pixel_size = (half_width * 2.0) / width
        self.half_width = half_width
        self.half_height = half_height
        self.aperture = aperture
        self.focal_length = focal_length
        self.transform = gx.view_transform(
            np.asarray(from_p, dtype=np.float64),
            np.asarray(look_at, dtype=np.float64),
            np.array([0.0, 1.0, 0.0, 0.0]),
        )
        self.inverse = gm.inverse(self.transform)

    def pack(self, dtype=torch.float32, device=None) -> "CameraArrays":
        def t(v):
            return torch.as_tensor(np.asarray(v, dtype=np.float64),
                                   dtype=dtype, device=device)
        return CameraArrays(
            inverse=t(self.inverse), pixel_size=t(self.pixel_size),
            half_width=t(self.half_width), half_height=t(self.half_height),
            aperture=t(self.aperture), focal_length=t(self.focal_length))


class CameraArrays(NamedTuple):
    """Device-side camera parameters (reference CLCamera,
    ocltracer.go:80-96): 0-d tensors but the [4, 4] inverse."""
    inverse: torch.Tensor
    pixel_size: torch.Tensor
    half_width: torch.Tensor
    half_height: torch.Tensor
    aperture: torch.Tensor
    focal_length: torch.Tensor


def rays_for_pixels(cam: CameraArrays, px: torch.Tensor, py: torch.Tensor,
                    jitter_x: torch.Tensor, jitter_y: torch.Tensor,
                    sample_idx: torch.Tensor, total_samples: int
                    ) -> Tuple[Vec3, Vec3]:
    """Batched rayForPixel (tracer.cl:745-779): pixel coordinates, jitter
    in [0, 1) and sample numbers, all [R], to (origin, direction) Vec3s of
    [R], as the JAX package computes them: the view-plane point at z = -1
    through the camera inverse, no normalization of the depth-of-field
    direction (tracer.cl:774) and the reference's swapped sunflower x/y
    aperture offsets (tracer.cl:768-769)."""
    dt = cam.inverse.dtype
    x_off = cam.pixel_size * (px.to(dt) + jitter_x)
    y_off = cam.pixel_size * (py.to(dt) + jitter_y)

    point_in_view = Vec3(
        cam.half_width - x_off,
        cam.half_height - y_off,
        -torch.ones_like(x_off),
    )
    pixel = mat_apply_point(cam.inverse, point_in_view)
    zero = torch.zeros_like(x_off)
    origin = mat_apply_point(cam.inverse, Vec3(zero, zero, zero))
    direction = (pixel - origin).normalized()

    # depth-of-field branch (both are cheap; select elementwise)
    focal_point = origin + direction * cam.focal_length
    sx, sy = sunflower(total_samples, 2.0, sample_idx.to(dt))
    dof_origin = Vec3(
        origin.x + sy * cam.aperture,  # note: sy -> x (reference swap)
        origin.y + sx * cam.aperture,
        origin.z,
    )
    dof_dir = focal_point - dof_origin

    use_dof = cam.aperture != 0.0
    return (
        Vec3.where(use_dof, dof_origin, origin),
        Vec3.where(use_dof, dof_dir, direction),
    )
