"""Scene `reflection` (reflections.go:12): the reference scene with a
mirror left sphere. The textured scenes of the JAX package's
scenes/textured.py wait for the texture slice (ROADMAP queue 1, item 9)."""
from __future__ import annotations

from ..config import RenderConfig
from ..geometry import transforms as gx
from ..scene.material import Material
from ..scene.pack import Scene
from ..scene.shapes import Sphere
from . import register
from .cornell import cornell_walls, default_camera


@register("reflection")
def reflections_scene(cfg: RenderConfig) -> Scene:
    """ReflectionsScene (reflections.go:12): the reference scene with a
    mirror left sphere."""
    left_wall, right_wall, floor, ceil, back_wall, _front = cornell_walls()

    left_sphere = Sphere()
    left_sphere.set_transform(gx.translate(-0.35, -0.28, -0.15))
    left_sphere.set_transform(gx.scale(0.12, 0.12, 0.12))
    left_sphere.set_material(Material.mirror())

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
