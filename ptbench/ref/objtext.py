"""The mesh input both sides read: the .obj text of a configuration's
model, and the reference's own parser of it.

The repository ships no .obj files, so a configuration whose upstream
model is missing names a stand-in (`"model": {"kind": "uv_sphere", ...}`)
that the benchmark writes as text; the program loads that text through
its asset path (PT_ASSETS) and the reference parses the same text here.
"""
from __future__ import annotations

import math

import numpy as np


def uv_sphere_text(n_lat: int, n_lon: int, name: str) -> str:
    """A unit UV sphere of 2 * n_lon * (n_lat - 1) triangles, as .obj text
    with a `vn` line per vertex (the outward normal) and faces `a//a`:
    n_lat bands of n_lon quads, the two polar bands one triangle a quad."""
    lines = [f"g {name}"]
    verts = []
    for i in range(n_lat + 1):
        phi = math.pi * i / n_lat
        for j in range(n_lon):
            theta = 2.0 * math.pi * j / n_lon
            verts.append((math.sin(phi) * math.cos(theta), math.cos(phi),
                          math.sin(phi) * math.sin(theta)))
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"vn {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]

    def vid(i, j):
        return i * n_lon + (j % n_lon) + 1

    for i in range(n_lat):
        for j in range(n_lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j + 1), vid(i + 1, j)
            if i > 0:
                lines.append(f"f {a}//{a} {b}//{b} {c}//{c}")
            if i < n_lat - 1:
                lines.append(f"f {a}//{a} {c}//{c} {d}//{d}")
    return "\n".join(lines) + "\n"


def model_text(model: dict) -> str:
    """The .obj text of a configuration's `model` entry."""
    if model["kind"] != "uv_sphere":
        raise ValueError(f"no generator for model kind {model['kind']!r}")
    text = uv_sphere_text(model["lat"], model["lon"], model["group"])
    n = 2 * model["lon"] * (model["lat"] - 1)
    if n != model["triangles"]:
        raise ValueError(f"the stand-in has {n} triangles, the "
                         f"configuration states {model['triangles']}")
    return text


def parse(text: str):
    """Triangles of .obj text with v, vn and f lines (polygons fanned from
    their first vertex, indices from 1): float64 [N, 3] arrays (p1, p2,
    p3, n1, n2, n3). A face without normals takes its face normal,
    normalize(e2 x e1), at each vertex. Materials are not read: every
    triangle is white."""
    verts = [np.zeros(3)]
    norms = [np.zeros(3)]
    tris = []
    for row in text.split("\n"):
        parts = row.split()
        if not parts:
            continue
        tag = parts[0]
        if tag == "v":
            verts.append(np.array([float(p) for p in parts[1:4]]))
        elif tag == "vn":
            norms.append(np.array([float(p) for p in parts[1:4]]))
        elif tag == "f":
            idx = [p.split("/") for p in parts[1:]]
            for k in range(1, len(idx) - 1):
                corners = (idx[0], idx[k], idx[k + 1])
                p = [verts[int(c[0])] for c in corners]
                if len(corners[0]) == 3 and corners[0][2]:
                    n = [norms[int(c[2])] for c in corners]
                else:
                    face = np.cross(p[2] - p[0], p[1] - p[0])
                    mag = np.sqrt(np.sum(face * face))
                    n = [face / mag if mag > 0.0 else face] * 3
                tris.append((*p, *n))
        elif tag in ("mtllib", "usemtl"):
            raise ValueError("the reference parser reads no materials")
    arr = np.asarray(tris, dtype=np.float64)      # [N, 6, 3]
    return tuple(arr[:, k] for k in range(6))
