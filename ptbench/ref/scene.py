"""The reference's scene: object rows, camera and mesh tables built from a
configuration file's scene description and the model's .obj text.

The rows hold what the renderer's semantics read, as float32 from float64
host math: each object's inverse and inverse-transpose (of the product of
its transforms, each right-multiplied, as the upstream SetTransform
accumulates them), color, emission, refractive index, reflectivity, the
cylinder's y range, a group's object-space box; the camera's inverse
view, pixel size and half extents (upstream camera.NewCamera). The mesh
tables are the triangles' test records (the dual basis: p1, Ng = e1 x e2,
U = e2 x Ng / |Ng|^2, V = Ng x e1 / |Ng|^2, in float32), their shading
records (n1, n2 - n1, n3 - n1, color) and the reference's own BVH.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import bvh, objtext

TYPES = {"plane": 0, "sphere": 1, "cylinder": 2, "box": 3, "group": 4}
GROUP = TYPES["group"]
OBJ_COLS = 45


def _translate(x, y, z):
    m = np.eye(4)
    m[0, 3], m[1, 3], m[2, 3] = x, y, z
    return m


def _scale(x, y, z):
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = x, y, z
    return m


def _rotate(axis: int, r: float):
    m = np.eye(4)
    c, s = np.cos(r), np.sin(r)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i], m[j, j] = c, c
    # rotate_y's sine sits the other way round (upstream rotation.go)
    m[i, j], m[j, i] = (s, -s) if axis == 1 else (-s, s)
    return m


def transform_of(ops) -> np.ndarray:
    """The product of a list of transforms, each right-multiplied:
    ["translate", x, y, z], ["scale", x, y, z], ["rotate_x_pi", k]
    (k * pi radians; also y, z)."""
    m = np.eye(4)
    for op, *a in ops:
        if op == "translate":
            t = _translate(*a)
        elif op == "scale":
            t = _scale(*a)
        elif op.startswith("rotate_") and op.endswith("_pi"):
            t = _rotate("xyz".index(op[7]), a[0] * math.pi)
        else:
            raise ValueError(f"unknown transform {op!r}")
        m = m @ t
    return m


def camera_vec(cam: dict, width: int, height: int) -> list:
    """[inverse view 3x4, pixel size, half width, half height, aperture,
    focal length] as float32 values (upstream camera.NewCamera and
    ViewTransform)."""
    if cam.get("aperture", 0.0) != 0.0:
        raise ValueError("the reference renders without depth of field")
    half_view = math.tan((math.pi / cam["fov_pi_over"]) / 2.0)
    aspect = width / height
    if aspect >= 1.0:
        half_w, half_h = half_view, half_view / aspect
    else:
        half_w, half_h = half_view * aspect, half_view
    frm = np.array([*cam["from"], 1.0])
    to = np.array([*cam["to"], 1.0])
    up = np.array([0.0, 1.0, 0.0, 0.0])

    def norm(a):
        return a / np.sqrt(np.sum(a * a, axis=-1))

    def cross(a, b):
        return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                         a[0] * b[1] - a[1] * b[0], 0.0])

    fwd = norm(to - frm)
    left = cross(fwd, norm(up))
    true_up = cross(left, fwd)
    vt = np.eye(4)
    vt[0, :3], vt[1, :3], vt[2, :3] = left[:3], true_up[:3], -fwd[:3]
    inv = np.linalg.inv(vt @ _translate(-frm[0], -frm[1], -frm[2]))
    vec = np.zeros(17, dtype=np.float32)
    vec[0:12] = inv.astype(np.float32)[:3, :].reshape(12)
    vec[12:17] = ((half_w * 2.0) / width, half_w, half_h, 0.0, 0.0)
    return vec.tolist()


class RefScene(NamedTuple):
    obj: list                 # object rows as nested lists of floats
    obj_table: torch.Tensor   # [No, 45] f32 (the same rows)
    types: tuple              # type code of each object
    cam: list                 # the camera vector's 17 floats
    nodes: torch.Tensor       # [Nn, 8] f32
    links: torch.Tensor       # [Nn, 2] int64: leaf start (or -1), exit
    tris: torch.Tensor        # [Ns, 12] f32 test records
    shade: torch.Tensor       # [Ns, 12] f32 shading records
    groups: dict              # object index -> (first node, end node)
    tri_ids: np.ndarray = None  # [Ns] the triangle of each slot, -1 none

    @property
    def has_mesh(self) -> bool:
        return bool(self.groups)


def mesh_records(p1, p2, p3, n1, n2, n3, color, slots):
    """The test and shading records of the triangle slots `slots` (ids
    into the arrays; -1 a zero row)."""
    valid = slots >= 0
    idx = np.clip(slots, 0, None)

    def g(a):
        out = a[idx].copy()
        out[~valid] = 0.0
        return out

    gp1 = g(p1)
    e1 = (g(p2) - gp1).astype(np.float32)
    e2 = (g(p3) - gp1).astype(np.float32)
    ng = np.cross(e1, e2)
    l2 = (ng * ng).sum(axis=1, keepdims=True)
    safe = np.where(l2 > 0.0, l2, 1.0)
    uu = np.where(l2 > 0.0, np.cross(e2, ng) / safe, 0.0)
    vv = np.where(l2 > 0.0, np.cross(ng, e1) / safe, 0.0)
    f = np.float32
    gn1 = g(n1).astype(f)
    tris = np.concatenate([gp1.astype(f), ng, uu, vv], axis=1).astype(f)
    shade = np.concatenate([gn1, g(n2).astype(f) - gn1,
                            g(n3).astype(f) - gn1, g(color).astype(f)],
                           axis=1).astype(f)
    return tris, shade


LEAF = 4   # triangles a leaf of the reference's BVH


def build(config: dict, obj_text: str, device) -> RefScene:
    """The scene of `config` (its "scene" entry) at the configuration's
    width and height, with every group's triangles parsed from
    `obj_text`."""
    sc = config["scene"]
    rows, types, groups = [], [], {}
    node_parts, tri_parts, shade_parts, id_parts = [], [], [], []
    n_nodes = n_slots = 0
    for j, o in enumerate(sc["objects"]):
        code = TYPES[o["type"]]
        tr = transform_of(o.get("transform", []))
        inv = np.linalg.inv(tr)
        row = np.zeros(OBJ_COLS, dtype=np.float32)
        row[0:12] = inv.astype(np.float32)[:3, :].reshape(12)
        row[12:24] = inv.T.astype(np.float32)[:3, :].reshape(12)
        row[24:27] = o.get("color", (1.0, 1.0, 1.0))
        row[27:30] = o.get("emission", (0.0, 0.0, 0.0))
        row[30] = o.get("refractive_index", 1.0)
        row[31] = o.get("reflectivity", 0.0)
        if code == TYPES["cylinder"]:
            row[32], row[33] = o["min_y"], o["max_y"]
        tr32 = tr.astype(np.float32)
        row[40:43] = tr32[:3, 3]
        row[43] = max(tr32[0, 0], tr32[1, 1], tr32[2, 2])
        row[44] = tr32[0, 0]
        if code == GROUP:
            p1, p2, p3, n1, n2, n3 = objtext.parse(obj_text)
            pts = np.concatenate([p1, p2, p3])
            row[34:37] = pts.min(axis=0)
            row[37:40] = pts.max(axis=0)
            nodes, slots = bvh.build(p1, p2, p3, LEAF)
            nodes[:, 3] = np.where(nodes[:, 3] >= 0, nodes[:, 3] + n_slots,
                                   -1.0)
            nodes[:, 7] += n_nodes
            tris, shade = mesh_records(p1, p2, p3, n1, n2, n3,
                                       np.ones_like(p1), slots)
            groups[j] = (n_nodes, n_nodes + nodes.shape[0])
            n_nodes += nodes.shape[0]
            n_slots += slots.shape[0]
            node_parts.append(nodes)
            tri_parts.append(tris)
            shade_parts.append(shade)
            id_parts.append(slots)
        rows.append(row)
        types.append(code)
    table = np.stack(rows)

    def t(parts, cols):
        a = (np.concatenate(parts) if parts
             else np.zeros((1, cols), dtype=np.float32))
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    nodes = t(node_parts, 8)
    return RefScene(
        obj=table.tolist(), obj_table=torch.from_numpy(table).to(device),
        types=tuple(types),
        cam=camera_vec(sc["camera"], config["width"], config["height"]),
        nodes=nodes, links=nodes[:, [3, 7]].long(), tris=t(tri_parts, 12),
        shade=t(shade_parts, 12), groups=groups,
        tri_ids=np.concatenate(id_parts) if id_parts else None)
