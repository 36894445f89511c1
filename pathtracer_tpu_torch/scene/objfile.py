"""Wavefront .OBJ / .MTL parsing (counterpart of pathtracer_tpu.scene.objfile).
The scene core (native.py) parses .obj files with the same result bit for
bit; this is the plain version it is held to, and the path under
PT_NATIVE=0.

Behavioral equivalent of the reference parser (internal/app/obj/objparser.go):
- v/vn/f/g/o/mtllib/usemtl handling, fan triangulation of polygons
  (objparser.go:62-106), 1-indexed arrays with placeholder slot 0
  (objparser.go:22-23)
- ParseMtl for Ka/Kd/Ks/Ns/Ni/d (objparser.go:230-273); toMaterial sums
  Ka+Kd+Ks into one RGB (objparser.go:181-196)
- ComputeVertexNormals: the reference does an O(n^2) position-matching scan
  (objparser.go:137-178); we get the identical result with a hash-map over
  vertex positions in O(n).
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from ..geometry import tuple4 as gt
from .material import Material, Mtl
from .shapes import Group, Triangle


class Obj:
    def __init__(self):
        # slot 0 placeholders (objparser.go:22-23)
        self.vertices: List[np.ndarray] = [np.array([0.0, 0.0, 0.0, 1.0])]
        self.normals: List[np.ndarray] = [np.array([0.0, 0.0, 0.0, 0.0])]
        self.groups: Dict[str, Group] = {}
        self.group_order: List[str] = []
        self.ignored_lines = 0

    def to_group(self) -> Group:
        """One ROOT group of named groups (objparser.go:208)."""
        root = Group(label="ROOT")
        for name in self.group_order:
            root.add_child(self.groups[name])
        return root

    def default_group(self) -> Group:
        return self.groups["DefaultGroup"]

    def all_triangles(self) -> List[Triangle]:
        out: List[Triangle] = []
        for name in self.group_order:
            out.extend(
                c for c in self.groups[name].children if isinstance(c, Triangle)
            )
        return out


def parse_obj(data: str, mtl_dir: str = ".") -> Obj:
    out = Obj()
    mats: Dict[str, Mtl] = {}
    current_group = "DefaultGroup"
    current_material = Material.default()
    out.groups[current_group] = Group(label=current_group)
    out.group_order.append(current_group)

    for row in data.split("\n"):
        row = row.strip()
        if not row:
            out.ignored_lines += 1
            continue
        parts = row.split()
        tag = parts[0]

        if tag == "mtllib":
            path = os.path.join(mtl_dir, parts[1])
            with open(path) as f:
                mats = parse_mtl(f.read())
        elif tag == "usemtl":
            mtl = mats.get(parts[1])
            if mtl is not None:
                current_material = mtl.to_material()
                out.groups[current_group].material = current_material
        elif tag == "v":
            out.vertices.append(
                gt.point(float(parts[1]), float(parts[2]), float(parts[3]))
            )
        elif tag == "vn":
            out.normals.append(
                gt.vector(float(parts[1]), float(parts[2]), float(parts[3]))
            )
        elif tag == "f":
            # fan triangulation (objparser.go:62-106)
            if "/" not in row:
                for i in range(2, len(parts) - 1):
                    i1, i2, i3 = int(parts[1]), int(parts[i]), int(parts[i + 1])
                    tri = Triangle(
                        out.vertices[i1], out.vertices[i2], out.vertices[i3]
                    )
                    # plain-vertex faces keep the default material — the
                    # reference only assigns currentMaterial on the v/t/n
                    # branch (objparser.go:58-71 vs 74-106)
                    out.groups[current_group].add_child(tri)
            else:
                for i in range(2, len(parts) - 1):
                    sp1 = parts[1].split("/")
                    sp2 = parts[i].split("/")
                    sp3 = parts[i + 1].split("/")
                    i1, i2, i3 = int(sp1[0]), int(sp2[0]), int(sp3[0])
                    n1 = n2 = n3 = 0
                    if len(sp1) == 3 and sp1[2]:
                        n1, n2, n3 = int(sp1[2]), int(sp2[2]), int(sp3[2])
                    tri = Triangle(
                        out.vertices[i1], out.vertices[i2], out.vertices[i3],
                        out.normals[n1], out.normals[n2], out.normals[n3],
                    )
                    tri.material = current_material
                    out.groups[current_group].add_child(tri)
        elif tag in ("g", "o"):
            current_group = parts[1]
            if current_group not in out.groups:
                out.groups[current_group] = Group(label=current_group)
                out.group_order.append(current_group)
        else:
            out.ignored_lines += 1
    return out


def parse_obj_file(path: str) -> Obj:
    with open(path) as f:
        return parse_obj(f.read(), mtl_dir=os.path.dirname(path) or ".")


def parse_mtl(data: str) -> Dict[str, Mtl]:
    """(objparser.go:230-273)"""
    out: Dict[str, Mtl] = {}
    current: Optional[str] = None
    for row in data.split("\n"):
        row = row.strip()
        if not row:
            continue
        parts = row.split()
        tag = parts[0]
        if tag == "newmtl":
            current = parts[1]
            out[current] = Mtl(name=current)
        elif current is None:
            continue
        elif tag == "Ns":
            out[current].shininess = float(parts[1])
        elif tag == "Ka":
            out[current].ambient = tuple(float(x) for x in parts[1:4])
        elif tag == "Kd":
            out[current].diffuse = tuple(float(x) for x in parts[1:4])
        elif tag == "Ks":
            out[current].specular = tuple(float(x) for x in parts[1:4])
        elif tag == "Ni":
            out[current].refractive_index = float(parts[1])
        elif tag == "d":
            out[current].transparency = 1.0 - float(parts[1])
    return out


def compute_vertex_normals(tris: List[Triangle]) -> None:
    """Average face normals of all triangles sharing each vertex position
    into per-vertex normals N1/N2/N3. Result identical to the reference's
    O(n^2) scan (objparser.go:137-178); hash-map makes it O(n)."""
    acc: Dict[bytes, np.ndarray] = defaultdict(lambda: np.zeros(4))

    def key(p: np.ndarray) -> bytes:
        return p[:3].tobytes()

    for t in tris:
        for p in (t.p1, t.p2, t.p3):
            acc[key(p)] += t.n

    for t in tris:
        # the reference seeds each vertex normal with the face's own normal
        # and adds every OTHER face sharing the position; the accumulated
        # sum already includes our own face exactly once.
        t.n1 = gt.normalize(acc[key(t.p1)])
        t.n2 = gt.normalize(acc[key(t.p2)])
        t.n3 = gt.normalize(acc[key(t.p3)])
