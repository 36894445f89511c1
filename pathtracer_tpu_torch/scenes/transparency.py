"""Transparency scenes: `transparency`, `transparency_quad_lights`,
`transparency_f_light`.

Constants ported verbatim from internal/app/scenes/{transparency.go,
transparency_quadlights.go:13, transparency_f_light.go}. This family moves
the back wall to z=0.6 and keeps 8-char debug labels like the reference.
"""
from __future__ import annotations

from ..config import RenderConfig
from ..geometry import transforms as gx
from ..scene.material import Material
from ..scene.pack import Scene
from ..scene.shapes import Cube, Sphere
from . import register
from .cornell import back_wall_at, cornell_walls, default_camera


def _walls():
    left_wall, right_wall, floor, ceil, _back, front_wall = cornell_walls()
    return left_wall, right_wall, floor, ceil, back_wall_at(0.6), front_wall


def _sphere(label, translate, scale, material):
    s = Sphere(label=label)
    s.set_transform(gx.translate(*translate))
    s.set_transform(gx.scale(scale, scale, scale))
    s.set_material(material)
    return s


def _diffuse_157():
    m = Material.diffuse(0.9, 0.8, 0.7)
    m.refractive_index = 1.57
    return m


@register("transparency")
def transparency_scene(cfg: RenderConfig) -> Scene:
    """TransparencyScene: glass / diffuse-1.57 / mirror spheres under a
    flattened sphere light (transparency.go)."""
    left_wall, right_wall, floor, ceil, back_wall, _front = _walls()

    left_sphere = _sphere("left_spr", (-0.25, -0.28, 0.25), 0.12,
                          Material.glass())
    middle_sphere = _sphere("mddl_spr", (0, -0.24, -0.30), 0.16,
                            _diffuse_157())
    right_sphere = _sphere("right_spr", (0.25, -0.28, 0.25), 0.12,
                           Material.mirror())

    lightsource = Sphere(label="light   ")
    lightsource.set_transform(gx.translate(0, 0.399, 0))
    lightsource.set_transform(gx.scale(0.283, 0.01, 0.283))
    light = Material.light_bulb()
    light.emission = (9.0, 9.0, 9.0)
    light.color = (1.0, 1.0, 1.0)
    lightsource.set_material(light)

    objects = [lightsource, floor, ceil, left_wall, right_wall, back_wall,
               left_sphere, middle_sphere, right_sphere]
    return Scene(camera=default_camera(cfg), objects=objects)


def _quad_spheres():
    left_sphere = _sphere("left_spr", (-0.25, -0.18, 0.25), 0.14,
                          Material.glass())
    middle_sphere = _sphere("mddl_spr", (0, -0.24, -0.30), 0.16,
                            _diffuse_157())
    right_sphere = _sphere("right_spr", (0.35, -0.23, 0.2), 0.17,
                           Material.mirror())
    return left_sphere, middle_sphere, right_sphere


@register("transparency_quad_lights")
def transparency_quad_lights_scene(cfg: RenderConfig) -> Scene:
    """2x2 grid of flat cube area lights (transparency_quadlights.go:86-97)."""
    left_wall, right_wall, floor, ceil, back_wall, _front = _walls()
    left_sphere, middle_sphere, right_sphere = _quad_spheres()

    lights = []
    for i in range(2):
        for j in range(2):
            lt = Cube(label=f"light {i}-{j}")
            lt.set_transform(
                gx.translate(-0.25 + i * 0.5, 0.399, -0.25 + j * 0.5))
            lt.set_transform(gx.scale(0.15, 0.01, 0.15))
            lt.set_material(Material.light_bulb())
            lt.material.emission = (9.0, 9.0, 9.0)
            lt.material.color = (1.0, 1.0, 1.0)
            lights.append(lt)

    objects = [floor, ceil, left_wall, right_wall, back_wall,
               left_sphere, middle_sphere, right_sphere] + lights
    return Scene(camera=default_camera(cfg), objects=objects)


@register("transparency_f_light")
def transparency_f_light_scene(cfg: RenderConfig) -> Scene:
    """"F"-shaped light from 3 thin cubes (transparency_f_light.go:87-106)."""
    left_wall, right_wall, floor, ceil, back_wall, _front = _walls()
    left_sphere, middle_sphere, right_sphere = _quad_spheres()

    light_mtl = Material.light_bulb()
    light_mtl.emission = (9.0, 9.0, 9.0)
    light_mtl.color = (1.0, 1.0, 1.0)

    light1 = Cube(label="light 1")
    light1.set_transform(gx.translate(-0.125, 0.3999, 0.05))
    light1.set_transform(gx.scale(0.05, 0.01, 0.45))
    light1.set_material(light_mtl)

    light2 = Cube(label="light top")
    light2.set_transform(gx.translate(-0.02, 0.3999, -0.35))
    light2.set_transform(gx.scale(0.075, 0.01, 0.05))
    light2.set_material(light_mtl)

    light3 = Cube(label="light middle")
    light3.set_transform(gx.translate(-0.05, 0.3999, 0))
    light3.set_transform(gx.scale(0.075, 0.01, 0.05))
    light3.set_material(light_mtl)

    objects = [floor, ceil, left_wall, right_wall, back_wall, left_sphere,
               middle_sphere, right_sphere, light1, light2, light3]
    return Scene(camera=default_camera(cfg), objects=objects)
