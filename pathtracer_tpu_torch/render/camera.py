"""Host camera: fov -> half-extents/pixel size and the look-at view
transform (reference camera.NewCamera, camera/camera.go:21-48).

Counterpart of the host `Camera` of pathtracer_tpu.render.camera. The
megakernel takes the camera as a flat vector (megakernel.build_camera_vec),
so the device-side CameraArrays waits for the wavefront slice.
"""
from __future__ import annotations

import math

import numpy as np

from ..geometry import matrix as gm
from ..geometry import transforms as gx


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
