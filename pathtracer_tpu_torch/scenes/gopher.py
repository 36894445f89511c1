"""Gopher scenes: `gopher`, `gopher-window`, `cubemap` (counterpart of
pathtracer_tpu.scenes.gopher).

Constants ported verbatim from internal/app/scenes/{gopher.go:14,
gopher-with-window.go:14, cubemap.go:15}. The gopher model carries .mtl
materials per named group — per-triangle colors flow through the packer's
triangle color array (scene/pack.py), matching the reference's CLTriangle
marshaling (internal/ocl/scene.go:116-127).
"""
from __future__ import annotations

import math

from ..assets import load_texture
from ..config import RenderConfig
from ..geometry import transforms as gx
from ..render.camera import Camera
from ..scene.material import Material
from ..scene.pack import Scene
from ..scene.shapes import Cube, Plane, Sphere
from . import register
from ._models import load_model, silver
from .cornell import cornell_walls, default_camera, _p


def _gopher_group(scale: float, translate=(-0.4, -0.15, 0.2),
                  reflectivity: float = 0.2):
    """Gopher loader (gopher.go:66-82): .obj has precomputed vertex normals,
    so no ComputeVertexNormals pass."""
    group = load_model("gopher.obj", normals_groups=0)
    group.set_transform(gx.translate(*translate))
    group.set_transform(gx.rotate_z(-math.pi / 2))
    group.set_transform(gx.rotate_x(-math.pi / 4))
    group.set_transform(gx.scale(scale, scale, scale))
    group.set_material(silver(reflectivity))
    group.bounds()
    return group


def _gopher_walls():
    """The gopher scenes move the back wall to z=1.4 (gopher.go:45)."""
    left_wall, right_wall, floor, ceil, _back, front_wall = cornell_walls()
    back_wall = Plane()
    back_wall.set_transform(gx.translate(0, 0, 1.4))
    back_wall.set_transform(gx.rotate_x(math.pi / 2))
    back_wall.set_material(Material.diffuse(0.9, 0.8, 0.7))
    return left_wall, right_wall, floor, ceil, back_wall, front_wall


def _half_mirror_sphere():
    s = Sphere()
    s.set_transform(gx.translate(0.28, -0.24, 0.15))
    s.set_transform(gx.scale(0.16, 0.16, 0.16))
    m = Material.mirror()
    m.reflectivity = 0.8
    m.color = (0.97, 0.97, 0.843)
    s.set_material(m)
    return s


def _ceiling_light():
    ls = Sphere()
    ls.set_transform(gx.translate(0, 1.36, 0))
    light = Material.light_bulb()
    light.emission = (9.0, 8.0, 6.0)
    ls.set_material(light)
    return ls


@register("gopher")
def gopher_scene(cfg: RenderConfig) -> Scene:
    """GopherScene (gopher.go:14): 16640-triangle gopher with .mtl
    materials, half-mirror sphere, ceiling sphere light."""
    left_wall, right_wall, floor, ceil, back_wall, front_wall = _gopher_walls()
    objects = [floor, ceil, left_wall, right_wall, back_wall, front_wall,
               _half_mirror_sphere(), _gopher_group(0.2), _ceiling_light()]
    return Scene(camera=default_camera(cfg), objects=objects)


@register("gopher-window")
def gopher_window_scene(cfg: RenderConfig) -> Scene:
    """GopherWindowScene (gopher-with-window.go:14): emissive window cube
    (emission 24) + 4 border cubes + gopher."""
    left_wall, right_wall, floor, ceil, back_wall, front_wall = _gopher_walls()

    window = Cube()
    window.set_transform(gx.translate(0.6, 0.1, 0))
    window.set_transform(gx.rotate_y(math.pi / 2))
    window.set_transform(gx.scale(0.1, 0.16, 0.002))
    wm = Material.diffuse(0.75, 0.75, 1.0)
    wm.emission = (24.0, 24.0, 24.0)
    window.set_material(wm)

    border_mtl = Material.diffuse(0.95, 0.95, 1.0)
    rborder = Cube()
    rborder.set_transform(gx.translate(0.6, 0.1, -0.1))
    rborder.set_transform(gx.rotate_y(math.pi / 2))
    rborder.set_transform(gx.scale(0.01, 0.16, 0.02))
    rborder.set_material(border_mtl)

    lborder = Cube()
    lborder.set_transform(gx.translate(0.6, 0.1, 0.1))
    lborder.set_transform(gx.rotate_y(math.pi / 2))
    lborder.set_transform(gx.scale(0.01, 0.16, 0.02))
    lborder.set_material(border_mtl)

    bborder = Cube()
    bborder.set_transform(gx.translate(0.6, -0.06, 0.0))
    bborder.set_transform(gx.rotate_x(math.pi / 2))
    bborder.set_transform(gx.rotate_y(math.pi / 2))
    bborder.set_transform(gx.scale(0.01, 0.11, 0.04))
    bborder.set_material(border_mtl)

    tborder = Cube()
    tborder.set_transform(gx.translate(0.6, 0.26, 0.0))
    tborder.set_transform(gx.rotate_x(math.pi / 2))
    tborder.set_transform(gx.rotate_y(math.pi / 2))
    tborder.set_transform(gx.scale(0.01, 0.11, 0.03))
    tborder.set_material(border_mtl)

    center_sphere = Sphere()
    center_sphere.set_transform(gx.translate(0, -0.28, -0.3))
    center_sphere.set_transform(gx.scale(0.12, 0.12, 0.12))
    center_sphere.set_material(Material.diffuse(0.9, 0.8, 0.7))

    objects = [floor, ceil, left_wall, right_wall, back_wall, window,
               lborder, rborder, bborder, tborder, front_wall,
               center_sphere, _half_mirror_sphere(), _gopher_group(0.2),
               _ceiling_light()]
    return Scene(camera=default_camera(cfg), objects=objects)


@register("cubemap")
def cubemap_scene(cfg: RenderConfig) -> Scene:
    """EnvironmentCubeMap (cubemap.go:15): cross-layout emissive cube map
    env + gopher + mirror sphere + big sphere light."""
    cam = Camera(
        cfg.width, cfg.height, math.pi / 3,
        _p(0, 0.3, -2.7), _p(0, 0.45, 0),
        aperture=cfg.aperture, focal_length=cfg.focal_length,
    )

    right_sphere = Sphere()
    right_sphere.set_transform(gx.translate(0.2, 1.0, 2.0))
    right_sphere.set_transform(gx.scale(0.26, 0.26, 0.26))
    right_sphere.set_material(Material.mirror())

    lightsource = Sphere()
    lightsource.set_transform(gx.translate(1.1, 1.0, -4.0))
    lightsource.set_transform(gx.scale(0.7, 0.7, 0.7))
    light = Material.light_bulb()
    light.emission = (19.5, 19.5, 19.5)
    lightsource.set_material(light)

    sky = Cube()
    sky.set_transform(gx.translate(0, 0, 0))
    sky.set_transform(gx.scale(5, 5, 5))
    sky.material = Material.default()
    sky.material.textured = True
    sky.material.texture_id = 0
    sky.material.texture_scale_x = 1.0
    sky.material.texture_scale_y = 1.0
    sky.material.emission = (1.0, 1.0, 1.0)
    sky.material.is_env_map = True

    group = _gopher_group(0.4, translate=(-0.7, -0.15, 0.2),
                          reflectivity=0.0)

    objects = [lightsource, right_sphere, sky, group]
    return Scene(camera=cam, objects=objects,
                 cube_textures=[load_texture("shrine_cubemap.jpeg")])
