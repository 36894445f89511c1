"""Materials (reference: internal/app/material/material.go:7-60, mtl.go:6-15)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class Material:
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    refractive_index: float = 1.0
    reflectivity: float = 0.0
    textured: bool = False
    texture_id: int = 0
    texture_scale_x: float = 1.0
    texture_scale_y: float = 1.0
    textured_nm: bool = False
    texture_id_nm: int = 0
    texture_scale_x_nm: float = 1.0
    texture_scale_y_nm: float = 1.0
    is_env_map: bool = False

    # ------------------------------------------------------------------
    # Presets (material.go:23-60)
    # ------------------------------------------------------------------
    @staticmethod
    def default() -> "Material":
        return Material(color=(1.0, 1.0, 1.0))

    @staticmethod
    def diffuse(r: float, g: float, b: float) -> "Material":
        return Material(color=(r, g, b))

    @staticmethod
    def glass() -> "Material":
        return Material(color=(1.0, 1.0, 1.0), refractive_index=1.52, reflectivity=0.05)

    @staticmethod
    def mirror() -> "Material":
        return Material(color=(1.0, 1.0, 1.0), reflectivity=1.0)

    @staticmethod
    def light_bulb() -> "Material":
        return Material(color=(1.0, 1.0, 1.0), emission=(8.0, 8.0, 8.0))


@dataclasses.dataclass
class Mtl:
    """Wavefront .mtl record (material/mtl.go:6-15)."""
    name: str = ""
    ambient: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    diffuse: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    specular: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    shininess: float = 0.0
    refractive_index: float = 1.0
    transparency: float = 0.0

    def to_material(self) -> Material:
        """Sum Ka+Kd+Ks into one RGB like the reference
        (obj/objparser.go:181-196 toMaterial)."""
        r = self.ambient[0] + self.diffuse[0] + self.specular[0]
        g = self.ambient[1] + self.diffuse[1] + self.specular[1]
        b = self.ambient[2] + self.diffuse[2] + self.specular[2]
        return Material(color=(r, g, b), refractive_index=self.refractive_index)
