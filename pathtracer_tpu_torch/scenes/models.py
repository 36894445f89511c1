"""Model scenes: `teapot`, `christian`, `transparent_teapot`, `glass`
(counterpart of pathtracer_tpu.scenes.models).

Constants ported verbatim from internal/app/scenes/{teapot.go:15,
christian.go:15, transparent_teapot.go:15, transparent_glass.go:15}.
Objects the reference constructs but never adds to the scene (teapot's
cylinder/cube, christian's lightsource/lightsource1/lightsource6) are
omitted here on purpose — they are dead code in the reference too.
"""
from __future__ import annotations

import math

from ..config import RenderConfig
from ..geometry import transforms as gx
from ..scene.material import Material
from ..scene.pack import Scene
from ..scene.shapes import Cube, Cylinder, Sphere
from . import register
from ._models import load_model, silver
from .cornell import back_wall_at, cornell_walls, default_camera


def _teapot_group(material: Material, translate, scale,
                  rotate_y: float = 0.0):
    """Teapot loader (teapot.go:79-104 / transparent_teapot.go:107-133):
    vertex normals over the first group's triangles, then transform chain.
    BVH leaf sizing is a packer concern in this framework (scene/bvh.py),
    not a scene concern like the reference's Divide threshold 50."""
    group = load_model("teapot.obj", normals_groups=1)
    group.set_transform(gx.translate(*translate))
    if rotate_y:
        group.set_transform(gx.rotate_y(rotate_y))
    group.set_transform(gx.scale(*scale))
    group.set_material(material)
    group.bounds()
    return group


@register("teapot")
def model_scene(cfg: RenderConfig) -> Scene:
    """ModelScene (teapot.go:15): Cornell box, silver teapot (refl 0.2),
    one diffuse sphere, flattened sphere light (emission 9,8,6)."""
    left_wall, right_wall, floor, ceil, back_wall, _front = cornell_walls()

    left_sphere = Sphere()
    left_sphere.set_transform(gx.translate(-0.35, -0.28, -0.15))
    left_sphere.set_transform(gx.scale(0.12, 0.12, 0.12))
    left_sphere.set_material(Material.diffuse(0.9, 0.8, 0.7))

    group = _teapot_group(silver(0.2), (0, -0.4, 0), (0.07, 0.07, 0.07))

    lightsource = Sphere()
    lightsource.set_transform(gx.translate(0, 0.4, 0))
    lightsource.set_transform(gx.scale(0.3, 0.03, 0.3))
    light = Material.light_bulb()
    light.emission = (9.0, 8.0, 6.0)
    lightsource.set_material(light)

    objects = [lightsource, floor, ceil, left_wall, right_wall, back_wall,
               group, left_sphere]
    return Scene(camera=default_camera(cfg), objects=objects)


@register("christian")
def christian_scene(cfg: RenderConfig) -> Scene:
    """ChristianScene (christian.go:15): teapot + 4 small sphere lights
    (emission 90,80,60) under reflective open cylinder covers."""
    left_wall, right_wall, floor, ceil, back_wall, _front = cornell_walls()

    left_sphere = Sphere()
    left_sphere.set_transform(gx.translate(-0.35, -0.28, -0.15))
    left_sphere.set_transform(gx.scale(0.12, 0.12, 0.12))
    left_sphere.set_material(Material.diffuse(0.9, 0.9, 0.9))
    left_sphere.material.reflectivity = 0.99

    group = _teapot_group(silver(0.2), (0, -0.4, 0), (0.07, 0.07, 0.07))

    light_mtl = Material.light_bulb()
    light_mtl.emission = (90.0, 80.0, 60.0)
    cover_mtl = Material.diffuse(0.8, 0.8, 0.8)
    cover_mtl.reflectivity = 0.95

    lights, covers = [], []
    for x in (-0.3, -0.1, 0.1, 0.3):
        ls = Sphere()
        ls.set_transform(gx.translate(x, 0.3, 0))
        ls.set_transform(gx.scale(0.03, 0.03, 0.03))
        ls.set_material(light_mtl)
        lights.append(ls)
        cover = Cylinder(min_y=0.0, max_y=1.0, closed=False)
        cover.set_transform(gx.translate(x, 0.295, 0))
        cover.set_transform(gx.scale(0.06, 0.4, 0.06))
        cover.set_material(cover_mtl)
        covers.append(cover)

    objects = lights + covers + [floor, ceil, left_wall, right_wall,
                                 back_wall, group, left_sphere]
    return Scene(camera=default_camera(cfg), objects=objects)


@register("transparent_teapot")
def transparent_teapot_scene(cfg: RenderConfig) -> Scene:
    """TransparentTeapotScene (transparent_teapot.go:15): thin-shell glass
    teapot via the refractiveIndex = -1.0 hack (transparent_teapot.go:79)."""
    left_wall, right_wall, floor, ceil, back_wall, _front = cornell_walls()
    # this scene family moves the back wall to z=0.6 (transparent_teapot.go:55)
    back_wall = back_wall_at(0.6)

    left_sphere = Sphere(label="left_spr")
    left_sphere.set_transform(gx.translate(-0.25, -0.28, 0.25))
    left_sphere.set_transform(gx.scale(0.12, 0.12, 0.12))
    left_sphere.set_material(Material.diffuse(0.9, 0.8, 0.7))

    right_sphere = Sphere(label="right_spr")
    right_sphere.set_transform(gx.translate(0.25, -0.28, 0.25))
    right_sphere.set_transform(gx.scale(0.12, 0.12, 0.12))
    right_sphere.set_material(Material.glass())

    mtrl = Material.glass()
    mtrl.refractive_index = -1.0
    mtrl.reflectivity = 0.2
    teapot = _teapot_group(mtrl, (0, -0.38, -0.2), (0.1, 0.1, 0.1),
                           rotate_y=math.pi / 12)
    teapot.label = "teapot  "

    lightsource = Sphere(label="light   ")
    lightsource.set_transform(gx.translate(0, 0.399, 0))
    lightsource.set_transform(gx.scale(0.283, 0.01, 0.283))
    light = Material.light_bulb()
    light.emission = (9.0, 9.0, 9.0)
    lightsource.set_material(light)

    objects = [lightsource, floor, ceil, left_wall, right_wall, back_wall,
               left_sphere, right_sphere, teapot]
    return Scene(camera=default_camera(cfg), objects=objects)


@register("glass")
def glass_scene(cfg: RenderConfig) -> Scene:
    """GlassScene (transparent_glass.go:15): glass .obj model (asset missing
    upstream; procedural goblet substitute), mirror+glass spheres, 2x2 quad
    cube lights (transparent_glass.go:86-97)."""
    left_wall, right_wall, floor, ceil, back_wall, front_wall = cornell_walls()
    back_wall = back_wall_at(0.6)

    left_sphere = Sphere(label="left_spr")
    left_sphere.set_transform(gx.translate(-0.2, -0.28, 0.25))
    left_sphere.set_transform(gx.scale(0.12, 0.12, 0.12))
    left_sphere.set_material(Material.mirror())

    right_sphere = Sphere(label="right_spr")
    right_sphere.set_transform(gx.translate(0.25, -0.28, 0.25))
    right_sphere.set_transform(gx.scale(0.12, 0.12, 0.12))
    right_sphere.set_material(Material.glass())

    mtrl = Material.glass()
    mtrl.reflectivity = 0.0
    glass_model = load_model("glass.obj", normals_groups=-1)
    glass_model.set_transform(gx.translate(-0.3, -0.395, -0.2))
    glass_model.set_transform(gx.scale(0.03, 0.03, 0.03))
    glass_model.set_material(mtrl)
    glass_model.bounds()
    glass_model.label = "glass   "

    lights = []
    for i in range(2):
        for j in range(2):
            lt = Cube(label=f"light {i}-{j}")
            lt.set_transform(
                gx.translate(-0.25 + i * 0.5, 0.4, -0.25 + j * 0.5))
            lt.set_transform(gx.scale(0.15, 0.001, 0.15))
            lt.set_material(Material.light_bulb())
            lt.material.emission = (10.0, 10.0, 10.0)
            lt.material.color = (1.0, 1.0, 1.0)
            lights.append(lt)

    objects = [floor, ceil, left_wall, right_wall, back_wall, front_wall,
               left_sphere, right_sphere, glass_model] + lights
    return Scene(camera=default_camera(cfg), objects=objects)

