"""Flatten the host scene graph into a static struct-of-arrays device scene.

Counterpart of pathtracer_tpu.scene.pack for untextured scenes of
primitives and triangle meshes: the same SceneArrays fields, shapes and
values (built in float64 numpy and cast at the end), as torch tensors on an
explicit device. Each Group's triangles go into one global skip-link BVH
pool (scene/bvh.py), with eight octant-ordered copies of its nodes.
Textures are not ported yet and raise instead of being dropped.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .bvh import FlatBVH, build_bvh, empty_bvh, octant_node_orders
from .shapes import Cylinder, Group, Shape, Triangle

NONE_TYPE = -1

_TEXTURE_ITEM = "ROADMAP queue 1, item 9 (textures)"


class SceneArrays(NamedTuple):
    """Device-side scene. All tensors have static (padded) shapes, with the
    JAX package's field names and layouts (pathtracer_tpu.scene.pack)."""
    obj_type: torch.Tensor          # [No] i32: 0 plane,1 sphere,2 cyl,3 box,4 group,-1 pad
    inverse: torch.Tensor           # [No,4,4]
    inverse_transpose: torch.Tensor # [No,4,4]
    transform: torch.Tensor         # [No,4,4]
    inv_affine: torch.Tensor        # [No,12] row-major 3x4 of inverse
    inv_t_affine: torch.Tensor      # [No,12] row-major 3x4 of inverse-transpose
    color: torch.Tensor             # [No,3]
    emission: torch.Tensor          # [No,3]
    refractive_index: torch.Tensor  # [No]
    reflectivity: torch.Tensor      # [No]
    min_y: torch.Tensor             # [No]
    max_y: torch.Tensor             # [No]
    bb_min: torch.Tensor            # [No,3] (group-local bounds)
    bb_max: torch.Tensor            # [No,3]
    bvh_root: torch.Tensor          # [No] i32 (-1 if not a group)
    bvh_end: torch.Tensor           # [No] i32
    is_textured: torch.Tensor       # [No] i32
    texture_index: torch.Tensor     # [No] i32
    texture_scale: torch.Tensor     # [No,2]
    is_textured_nm: torch.Tensor    # [No] i32
    texture_index_nm: torch.Tensor  # [No] i32
    texture_scale_nm: torch.Tensor  # [No,2]
    # BVH node pool (skip links; [9*Nn] with the octant copies)
    node_bb_min: torch.Tensor       # [Nn,3]
    node_bb_max: torch.Tensor       # [Nn,3]
    node_tri_start: torch.Tensor    # [Nn] i32
    node_is_leaf: torch.Tensor      # [Nn] i32
    node_exit: torch.Tensor         # [Nn] i32
    # triangle pool (LEAF_SIZE-aligned, degenerate-padded slots)
    tri_p1: torch.Tensor            # [Nt,3]
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_n3: torch.Tensor
    tri_color: torch.Tensor         # [Nt,3]
    # texture atlases and pools: the JAX package's empty placeholders
    # until the texture slice lands
    tex_planar: torch.Tensor        # [3, n, H, W]
    tex_sphere: torch.Tensor
    tex_cube: torch.Tensor
    tex_pool_u32: torch.Tensor      # [T] u32
    tex_pool_quad_u32: torch.Tensor # [T, 4] u32
    tex_base: torch.Tensor          # [No]
    tex_w: torch.Tensor             # [No]
    tex_h: torch.Tensor             # [No]
    tex_nm_base: torch.Tensor       # [No]
    tex_nm_w: torch.Tensor          # [No]
    tex_nm_h: torch.Tensor          # [No]
    tex_staged: torch.Tensor = None # [8, 128] zeros


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static (hashable) scene structure, field for field the JAX
    package's SceneMeta."""
    n_objects: int
    max_objects: int
    obj_types: Tuple[int, ...]
    group_indices: Tuple[int, ...]
    group_bvh: Tuple[Tuple[int, int, int], ...]
    n_nodes: int
    n_tri_slots: int
    leaf_size: int
    textured_types: Tuple[int, ...] = ()
    has_normal_maps: bool = False
    light_indices: Tuple[int, ...] = ()
    octant_orders: bool = False
    tri_uniform_color: "Tuple[float, float, float] | None" = None
    obj_tex: Tuple = ()
    obj_tex_nm: Tuple = ()

    @property
    def has_groups(self) -> bool:
        return len(self.group_indices) > 0


@dataclasses.dataclass
class Scene:
    """Host scene container (reference: internal/app/scenes/scene.go:16-28)."""
    camera: "object"
    objects: List[Shape]
    textures: List[np.ndarray] = dataclasses.field(default_factory=list)
    sphere_textures: List[np.ndarray] = dataclasses.field(default_factory=list)
    cube_textures: List[np.ndarray] = dataclasses.field(default_factory=list)

    def pack(self, device, **kw) -> Tuple["SceneArrays", "SceneMeta"]:
        return pack_scene(
            self.objects,
            device=device,
            textures=self.textures,
            sphere_textures=self.sphere_textures,
            cube_textures=self.cube_textures,
            **kw,
        )


def _check_supported(meta: SceneMeta) -> None:
    if meta.textured_types or meta.has_normal_maps or meta.obj_tex \
            or meta.obj_tex_nm:
        raise NotImplementedError(
            f"textured scenes are not ported yet: {_TEXTURE_ITEM}")


def pack_scene(
    objects: Sequence[Shape],
    device,
    leaf_size: Optional[int] = None,
    max_objects: Optional[int] = None,
    textures: Sequence[np.ndarray] = (),
    sphere_textures: Sequence[np.ndarray] = (),
    cube_textures: Sequence[np.ndarray] = (),
) -> Tuple[SceneArrays, SceneMeta]:
    """Pack an untextured scene onto `device` (float32).

    The BVH leaf size is PT_BVH_LEAF when set, else 32 for meshes of up to
    8000 triangles in all and 16 above (the JAX package's rule). Octant
    node copies are built unless PT_OCTANT=0. Raises NotImplementedError
    for textures."""
    n = len(objects)
    no = max_objects or max(16, n)
    if n > no:
        raise ValueError(f"{n} objects > padded capacity {no}")
    for s in objects:
        if s.material.textured or s.material.textured_nm:
            raise NotImplementedError(
                f"textured materials are not ported yet: {_TEXTURE_ITEM}")
    if len(textures) or len(sphere_textures) or len(cube_textures):
        raise NotImplementedError(
            f"texture images are not ported yet: {_TEXTURE_ITEM}")

    if leaf_size is None and os.environ.get("PT_BVH_LEAF"):
        leaf_size = int(os.environ["PT_BVH_LEAF"])
    if leaf_size is None:
        total_tris = sum(len(s.all_triangles()) for s in objects
                         if isinstance(s, Group))
        leaf_size = 32 if 0 < total_tris <= 8000 else 16

    obj_type = np.full(no, NONE_TYPE, dtype=np.int32)
    inverse = np.tile(np.eye(4), (no, 1, 1))
    inverse_t = np.tile(np.eye(4), (no, 1, 1))
    transform = np.tile(np.eye(4), (no, 1, 1))
    color = np.zeros((no, 3))
    emission = np.zeros((no, 3))
    refr_idx = np.ones(no)
    refl = np.zeros(no)
    min_y = np.zeros(no)
    max_y = np.zeros(no)
    bb_min = np.zeros((no, 3))
    bb_max = np.zeros((no, 3))
    bvh_root = np.full(no, -1, dtype=np.int32)
    bvh_end = np.full(no, -1, dtype=np.int32)

    pool: FlatBVH = empty_bvh(leaf_size)
    group_indices: List[int] = []
    group_bvh: List[Tuple[int, int, int]] = []
    for i, s in enumerate(objects):
        m = s.material
        obj_type[i] = s.type_code
        inverse[i] = s.inverse
        inverse_t[i] = s.inverse_transpose
        transform[i] = s.transform
        color[i] = np.asarray(m.color)[:3]
        emission[i] = np.asarray(m.emission)[:3]
        refr_idx[i] = m.refractive_index
        refl[i] = m.reflectivity
        if isinstance(s, Cylinder):
            min_y[i] = s.min_y
            max_y[i] = s.max_y
        elif isinstance(s, Group):
            tris = s.all_triangles()
            if not tris:
                # a group with no triangles contributes nothing (the
                # reference skips childCount==0 groups, tracer.cl:617)
                obj_type[i] = NONE_TYPE
                continue
            s.bounds()
            bb_min[i] = s.bounding_box.min[:3]
            bb_max[i] = s.bounding_box.max[:3]
            pool, root, end = build_bvh(tris, leaf_size=leaf_size, into=pool)
            bvh_root[i] = root
            bvh_end[i] = end
            group_indices.append(i)
            group_bvh.append((i, root, end))

    # a scene without triangles still gets a pool of one leaf holding one
    # degenerate triangle, so every table has at least one row
    dummy = pool.n_nodes == 0
    if dummy:
        pool, _, _ = build_bvh(
            [Triangle(np.zeros(4), np.zeros(4), np.zeros(4))],
            leaf_size=leaf_size, into=pool)

    # octant-ordered node copies for the walk's front-to-back pruning
    # (PT_OCTANT=0 disables; copy 0 stays the original order)
    n_pool_nodes = pool.n_nodes
    octant = (not dummy and bool(group_bvh)
              and os.environ.get("PT_OCTANT", "1") != "0")
    if octant:
        pool = octant_node_orders(pool, [(r, e) for (_, r, e) in group_bvh])

    def f(a):
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float32)).to(device)

    def i32(a):
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.int32)).to(device)

    def u32(a):
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.uint32)).to(device)

    arrays = SceneArrays(
        obj_type=i32(obj_type),
        inverse=f(inverse),
        inverse_transpose=f(inverse_t),
        transform=f(transform),
        inv_affine=f(inverse[:, :3, :].reshape(no, 12)),
        inv_t_affine=f(inverse_t[:, :3, :].reshape(no, 12)),
        color=f(color),
        emission=f(emission),
        refractive_index=f(refr_idx),
        reflectivity=f(refl),
        min_y=f(min_y),
        max_y=f(max_y),
        bb_min=f(bb_min),
        bb_max=f(bb_max),
        bvh_root=i32(bvh_root),
        bvh_end=i32(bvh_end),
        is_textured=i32(np.zeros(no)),
        texture_index=i32(np.zeros(no)),
        texture_scale=f(np.ones((no, 2))),
        is_textured_nm=i32(np.zeros(no)),
        texture_index_nm=i32(np.zeros(no)),
        texture_scale_nm=f(np.ones((no, 2))),
        node_bb_min=f(pool.node_bb_min),
        node_bb_max=f(pool.node_bb_max),
        node_tri_start=i32(pool.node_tri_start),
        node_is_leaf=i32(pool.node_is_leaf),
        node_exit=i32(pool.node_exit),
        tri_p1=f(pool.tri_p1),
        tri_e1=f(pool.tri_e1),
        tri_e2=f(pool.tri_e2),
        tri_n1=f(pool.tri_n1),
        tri_n2=f(pool.tri_n2),
        tri_n3=f(pool.tri_n3),
        tri_color=f(pool.tri_color),
        tex_planar=f(np.ones((3, 1, 1, 1))),
        tex_sphere=f(np.ones((3, 1, 1, 1))),
        tex_cube=f(np.ones((3, 1, 1, 1))),
        tex_pool_u32=u32(np.zeros(1)),
        tex_pool_quad_u32=u32(np.zeros((1, 4))),
        tex_base=f(np.zeros(no)),
        tex_w=f(np.ones(no)),
        tex_h=f(np.ones(no)),
        tex_nm_base=f(np.zeros(no)),
        tex_nm_w=f(np.ones(no)),
        tex_nm_h=f(np.ones(no)),
        tex_staged=f(np.zeros((8, 128))),
    )
    lights = tuple(
        i for i, s in enumerate(objects)
        if s.material.emission[0] > 0.0 and obj_type[i] != NONE_TYPE
    )
    # uniform triangle color: real (non-padding) slots have a nonzero
    # geometric normal; padding slots never hit, so only real slots count
    uni_color = None
    if not dummy:
        ng = np.cross(pool.tri_e1, pool.tri_e2)
        cols = np.asarray(pool.tri_color, dtype=np.float32)[
            (ng * ng).sum(axis=1) > 0.0]
        if len(cols) and bool(np.all(cols == cols[0])):
            uni_color = tuple(float(c) for c in cols[0])
    meta = SceneMeta(
        n_objects=n,
        max_objects=no,
        obj_types=tuple(int(t) for t in obj_type[:n]),
        group_indices=tuple(group_indices),
        group_bvh=tuple(group_bvh),
        n_nodes=int(n_pool_nodes) if not dummy else 0,
        n_tri_slots=int(pool.n_tri_slots),
        leaf_size=leaf_size,
        light_indices=lights,
        octant_orders=bool(octant),
        tri_uniform_color=uni_color,
    )
    return arrays, meta


def from_jax_scene(arrays, meta, device) -> Tuple[SceneArrays, SceneMeta]:
    """Carry a scene packed by the JAX package over to this one.

    `arrays` is the JAX package's SceneArrays with every field converted
    to numpy by the caller (a NamedTuple or a mapping of field name to
    array); `meta` is its SceneMeta. Returns this package's SceneArrays on
    `device` and SceneMeta. Mesh pools, group BVH ranges and octant copies
    carry over as they are; textures, which are not ported yet, raise, and
    so do non-finite group bounds."""
    fields = arrays._asdict() if hasattr(arrays, "_asdict") else dict(arrays)
    out_meta = SceneMeta(**{
        fd.name: getattr(meta, fd.name)
        for fd in dataclasses.fields(SceneMeta)})
    _check_supported(out_meta)
    groups = list(out_meta.group_indices)
    for name in ("bb_min", "bb_max"):
        if not np.isfinite(np.asarray(fields[name])[groups]).all():
            raise ValueError(
                "the JAX scene has non-finite group bounds (its Python .obj "
                "path packs NaN, ROADMAP queue 3); they would hide the mesh")
    out = {}
    for name in SceneArrays._fields:
        a = np.ascontiguousarray(np.asarray(fields[name]))
        out[name] = torch.from_numpy(a.copy()).to(device)
    return SceneArrays(**out), out_meta
