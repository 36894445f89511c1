"""Canvas: host-side pixel buffer.

Counterpart of pathtracer_tpu.io.canvas, for the reference's canvas
(internal/app/canvas/canvas.go:10-63): a W x H buffer of RGB colors with
indexed writes, and the lock-guarded write of its pre-OpenCL
multi-worker design (canvas.go:37-51) for multi-threaded host tools.
"""
from __future__ import annotations

import threading

import numpy as np


class Canvas:
    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.pixels = np.zeros((height, width, 3), dtype=np.float64)
        self._lock = threading.Lock()

    def write_pixel(self, x: int, y: int, color) -> None:
        self.pixels[y, x] = np.asarray(color)[:3]

    def write_pixel_mutex(self, x: int, y: int, color) -> None:
        """canvas.go:37-51 WritePixelMutex."""
        with self._lock:
            self.write_pixel(x, y, color)

    def pixel_at(self, x: int, y: int) -> np.ndarray:
        return self.pixels[y, x]

    def blit(self, img: np.ndarray) -> None:
        """Bulk write of a full [H, W, 3] render."""
        self.pixels[...] = img

    def to_image(self) -> np.ndarray:
        return self.pixels.astype(np.float32)
