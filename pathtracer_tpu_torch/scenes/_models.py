"""Shared model-loading helpers for the mesh scenes (counterpart of
pathtracer_tpu.scenes._models).

Mirrors the reference's per-scene loader idioms (teapot.go:79-104,
transparent_teapot.go:107-133, transparent_glass.go:117-140, gopher.go:66-82).
"""
from __future__ import annotations

import os

from .. import native
from ..assets import find_asset, load_obj_source
from ..scene.material import Material
from ..scene.objfile import compute_vertex_normals, parse_obj
from ..scene.shapes import Group


def load_model(name: str, normals_groups: int = 0) -> Group:
    """Parse `assets/<name>` (or a procedural substitute) into one ROOT
    group. If normals_groups != 0, compute smooth vertex normals over the
    triangles of the first N named groups (all of them when N < 0) BEFORE
    any transform, exactly as the reference loaders do (teapot.go:86-93:
    group.Children[0]; transparent_glass.go:124-133: Children[0] and
    Children[1]).

    The scene core (native.py) parses the model into arrays (Group.soup,
    no Triangle objects), equal to the Python parser's triangles bit for
    bit; PT_NATIVE=0 takes the Python parser, whose group holds a Group
    of Triangles for each named group."""
    path = find_asset(name)
    mtl_dir = os.path.dirname(path) if path else "."
    text = load_obj_source(name)
    if native.available():
        group = Group(label="ROOT")
        group.soup = native.parse_obj(text, mtl_dir=mtl_dir,
                                      normals_groups=normals_groups)
        group.bounds()
        return group

    model = parse_obj(text, mtl_dir=mtl_dir)
    group = model.to_group()

    if normals_groups != 0:
        n = len(group.children) if normals_groups < 0 else normals_groups
        tris = []
        for child in group.children[:n]:
            if isinstance(child, Group):
                tris.extend(t for t in child.children
                            if not isinstance(t, Group))
        compute_vertex_normals(tris)

    group.bounds()
    return group


def silver(reflectivity: float = 0.2) -> Material:
    m = Material.diffuse(0.75, 0.75, 0.75)
    m.reflectivity = reflectivity
    return m
