"""Cornell-box scenes: `reference` (scenes/reference.go:12) and the
`default` OCL scene (scenes/ocl.go:13), with the shared Cornell walls and
camera. Constants ported verbatim."""
from __future__ import annotations

import math

import numpy as np

from ..config import RenderConfig
from ..geometry import transforms as gx
from ..render.camera import Camera
from ..scene.material import Material
from ..scene.pack import Scene
from ..scene.shapes import Cube, Cylinder, Group, Plane, Sphere, Triangle
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


@register("default")
def ocl_scene(cfg: RenderConfig) -> Scene:
    """Default scene (scenes/ocl.go:13): Cornell box + diffuse/glass/
    half-mirror spheres + capped cylinder + rotated cube + 3-triangle group
    + sphere light (emission 9,8,6)."""
    left_wall, right_wall, floor, ceil, back_wall, _front = cornell_walls()

    left_sphere = Sphere()
    left_sphere.set_transform(gx.translate(-0.25, -0.24, 0.1))
    left_sphere.set_transform(gx.scale(0.16, 0.16, 0.16))
    left_sphere.set_material(Material.diffuse(0.9, 0.8, 0.7))

    middle_sphere = Sphere()
    middle_sphere.set_transform(gx.translate(0, -0.24, -0.30))
    middle_sphere.set_transform(gx.scale(0.16, 0.16, 0.16))
    middle_sphere.set_material(Material.glass())

    right_sphere = Sphere()
    right_sphere.set_transform(gx.translate(0.25, -0.24, 0.1))
    right_sphere.set_transform(gx.scale(0.16, 0.16, 0.16))
    half_mirror = Material.mirror()
    half_mirror.reflectivity = 0.8
    half_mirror.color = (0.97, 0.97, 0.843)
    right_sphere.set_material(half_mirror)

    cyl = Cylinder(min_y=0.0, max_y=0.4, closed=True)
    cyl.set_transform(gx.translate(0.45, -0.5, -0.2))
    cyl.set_transform(gx.scale(0.075, 1, 0.075))
    cyl.set_material(Material.diffuse(0.92, 0.4, 0.8))

    cube = Cube()
    cube.set_transform(gx.translate(-0.3, -0.375, -0.3))
    cube.set_transform(gx.scale(0.1, 0.05, 0.04))
    cube.set_transform(gx.rotate_y(math.pi / 4))
    cube.set_transform(gx.rotate_z(math.pi / 2))
    cube.set_material(Material.diffuse(0.25, 0.25, 0.75))

    lightsource = Sphere()
    lightsource.set_transform(gx.translate(0, 1.36, 0))
    light = Material.light_bulb()
    light.emission = (9.0, 8.0, 6.0)
    lightsource.set_material(light)

    tri1 = Triangle(_p(-0.2, -0.4, 0), _p(0.0, -0.4, 0), _p(0, -0.1, 0))
    tri2 = Triangle(_p(0, -0.4, 0), _p(0.2, -0.4, 0), _p(0, -0.1, 0))
    tri3 = Triangle(_p(0.1, -0.4, -0.4), _p(0, -0.1, 0), _p(0, -0.4, 0))
    group = Group()
    group.set_material(Material.diffuse(0.7, 0.4, 0.9))
    group.set_transform(gx.translate(0.15, 0, -0.25))
    group.add_children(tri1, tri2, tri3)
    group.bounds()

    objects = [floor, ceil, left_wall, right_wall, back_wall, left_sphere,
               right_sphere, cyl, cube, group, lightsource]
    return Scene(camera=default_camera(cfg), objects=objects)
