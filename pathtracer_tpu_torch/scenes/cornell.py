"""Cornell-box scene `reference` (scenes/reference.go:12) and the shared
Cornell walls and camera. Constants ported verbatim. The `default` scene
holds a triangle group and waits for the mesh slice."""
from __future__ import annotations

import math

import numpy as np

from ..config import RenderConfig
from ..geometry import transforms as gx
from ..render.camera import Camera
from ..scene.material import Material
from ..scene.pack import Scene
from ..scene.shapes import Plane, Sphere
from . import register


def _p(x, y, z):
    return np.array([x, y, z, 1.0])


def cornell_walls():
    """The shared Cornell-box idiom (ocl.go:20-51, reference.go:24-56)."""
    left_wall = Plane()
    left_wall.set_transform(gx.translate(-0.6, 0, 0))
    left_wall.set_transform(gx.rotate_z(math.pi / 2))
    left_wall.set_material(Material.diffuse(0.75, 0.25, 0.25))

    right_wall = Plane()
    right_wall.set_transform(gx.translate(0.6, 0, 0))
    right_wall.set_transform(gx.rotate_z(math.pi / 2))
    right_wall.set_material(Material.diffuse(0.25, 0.25, 0.75))

    floor = Plane()
    floor.set_transform(gx.translate(0, -0.4, 0))
    floor.set_material(Material.diffuse(0.9, 0.8, 0.7))

    ceil = Plane()
    ceil.set_transform(gx.translate(0, 0.4, 0))
    ceil.set_material(Material.diffuse(0.9, 0.8, 0.7))

    back_wall = Plane()
    back_wall.set_transform(gx.translate(0, 0, 0.4))
    back_wall.set_transform(gx.rotate_x(math.pi / 2))
    back_wall.set_material(Material.diffuse(0.9, 0.8, 0.7))

    front_wall = Plane()
    front_wall.set_transform(gx.translate(0, 0, -2))
    front_wall.set_transform(gx.rotate_x(math.pi / 2))
    front_wall.set_material(Material.diffuse(0.9, 0.8, 0.7))

    return left_wall, right_wall, floor, ceil, back_wall, front_wall


def back_wall_at(z: float):
    """Back wall variant used by the transparency scene family
    (pathtracer_tpu.scenes.models._back_wall_at)."""
    back_wall = Plane(label="backwall")
    back_wall.set_transform(gx.translate(0, 0, z))
    back_wall.set_transform(gx.rotate_x(math.pi / 2))
    back_wall.set_material(Material.diffuse(0.9, 0.8, 0.7))
    return back_wall


def default_camera(cfg: RenderConfig) -> Camera:
    """Shared camera: (0, 0.1, -1.5) looking at (0, 0.05, 0), fov pi/3."""
    return Camera(
        cfg.width, cfg.height, math.pi / 3,
        _p(0, 0.1, -1.5), _p(0, 0.05, 0),
        aperture=cfg.aperture, focal_length=cfg.focal_length,
    )


@register("reference")
def reference_scene(cfg: RenderConfig) -> Scene:
    """Benchmark scene (scenes/reference.go:12): Cornell box, two diffuse
    spheres, flattened-sphere area light."""
    left_wall, right_wall, floor, ceil, back_wall, _front = cornell_walls()

    left_sphere = Sphere()
    left_sphere.set_transform(gx.translate(-0.35, -0.28, -0.15))
    left_sphere.set_transform(gx.scale(0.12, 0.12, 0.12))
    left_sphere.set_material(Material.diffuse(0.9, 0.8, 0.7))

    right_sphere = Sphere()
    right_sphere.set_transform(gx.translate(0, -0.24, -0.30))
    right_sphere.set_transform(gx.scale(0.16, 0.16, 0.16))
    right_sphere.set_material(Material.diffuse(0.9, 0.8, 0.7))

    lightsource = Sphere()
    lightsource.set_transform(gx.translate(0, 0.399, 0))
    lightsource.set_transform(gx.scale(0.283, 0.01, 0.283))
    light = Material.light_bulb()
    light.emission = (9.0, 9.0, 9.0)
    lightsource.set_material(light)

    objects = [lightsource, floor, ceil, left_wall, right_wall, back_wall,
               left_sphere, right_sphere]
    return Scene(camera=default_camera(cfg), objects=objects)
