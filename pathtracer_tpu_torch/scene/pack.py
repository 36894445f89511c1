"""Flatten the host scene graph into a static struct-of-arrays device scene.

Counterpart of pathtracer_tpu.scene.pack: the same SceneArrays fields,
shapes and values (built in float64 numpy and cast at the end), as torch
tensors on an explicit device. Each Group's triangles go into one global
skip-link BVH pool (scene/bvh.py), with eight octant-ordered copies of its
nodes. Every texture of every kind goes at full resolution into one flat
rgb8 texel pool with a per-object (base, w, h), from which the CUDA kernel
fetches texels; SceneMeta records the same per-object texture programs and
staging markers as the JAX package's, whose TPU kernel needs them. The
differentiable render trains an f32 copy of the pool (`texel_params`), and
`atlas_to_texels`/`texels_to_atlas` map it to and from the JAX package's
staged atlas.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .bvh import (FlatBVH, build_bvh, build_bvh_arrays, empty_bvh,
                  octant_node_orders)
from .shapes import BOX, PLANE, SPHERE, Cylinder, Group, Shape, Triangle

NONE_TYPE = -1

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
    # texture atlases, channel-leading [3, n, H, W] (reference
    # image2d_array_t x3, ocltracer.go:228-254)
    tex_planar: torch.Tensor
    tex_sphere: torch.Tensor
    tex_cube: torch.Tensor
    # flat texel pool: every texture of every kind at full resolution,
    # rgb8 packed r | g << 8 | b << 16, with per-object (base, w, h);
    # bases are f32-exact (the pool stays below 2^24 texels)
    tex_pool_u32: torch.Tensor      # [T] u32
    # quad pool (PT_TEX_FETCH=quad): row i holds texel i's bilinear
    # footprint [c00, c01, c10, c11] with its texture's REPEAT wrap baked
    # in, for the wavefront's one-row fetch; else a [1, 4] placeholder
    tex_pool_quad_u32: torch.Tensor # [T, 4] u32
    tex_base: torch.Tensor          # [No] texel offset (color)
    tex_w: torch.Tensor             # [No]
    tex_h: torch.Tensor             # [No]
    tex_nm_base: torch.Tensor       # [No] (normal map; planes only)
    tex_nm_w: torch.Tensor          # [No]
    tex_nm_h: torch.Tensor          # [No]
    # the JAX package's staged atlas of small file textures, which its TPU
    # kernel fetches by one-hot matmuls because a TPU lane cannot gather.
    # Here the kernel loads from tex_pool_u32, so this stays an [8, 128]
    # zero placeholder
    tex_staged: torch.Tensor = None


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


def _pack_texture_atlas(images: Sequence[np.ndarray]) -> np.ndarray:
    """Stack images into channel-leading [3, n, H, W], padding to the max
    H/W by nearest resize (the reference requires same-size layers in
    image2d_array_t)."""
    if not images:
        return np.ones((3, 1, 1, 1))
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    out = np.zeros((3, len(images), h, w))
    for i, im in enumerate(images):
        if im.shape[0] != h or im.shape[1] != w:
            # nearest-neighbor resize to the common size
            yi = (np.arange(h) * im.shape[0] // h).clip(0, im.shape[0] - 1)
            xi = (np.arange(w) * im.shape[1] // w).clip(0, im.shape[1] - 1)
            im = im[yi][:, xi]
        out[:, i] = np.moveaxis(im[..., :3], -1, 0)
    return out


def _rgb8(im: np.ndarray) -> np.ndarray:
    """An image's texels packed r | g << 8 | b << 16 (u32 [h, w])."""
    q = np.clip(np.round(im[..., :3] * 255.0), 0, 255).astype(np.uint32)
    return q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)


def _build_texel_pool(kind_images):
    """Concatenate every texture of every kind into one flat rgb8-u32 pool
    at full resolution. Returns (pool [T] u32, {kind: [(base, w, h),
    ...]})."""
    chunks = []
    tables = {}
    off = 0
    for kind, images in kind_images.items():
        entries = []
        for im in images:
            h, w = im.shape[0], im.shape[1]
            chunks.append(_rgb8(im).reshape(-1))
            entries.append((off, w, h))
            off += h * w
        tables[kind] = entries
    pool = np.concatenate(chunks) if chunks else np.zeros(1, np.uint32)
    if pool.size >= 2 ** 24:
        raise ValueError(f"texel pool has {pool.size} texels; f32-exact "
                         "base offsets cap it at 2^24")
    return pool, tables


def _build_quad_pool(kind_images) -> np.ndarray:
    """The quad pool of _build_texel_pool's pool under PT_TEX_FETCH=quad:
    row i holds texel i's bilinear footprint [c00, c01, c10, c11] with its
    texture's REPEAT wrap baked in ([T, 4] u32), read by the wavefront's
    one-row fetch (uv.sample_texture_pool). It is 4x the pool, so under
    any other fetch it is a [1, 4] placeholder."""
    if os.environ.get("PT_TEX_FETCH", "take4") != "quad":
        return np.zeros((1, 4), np.uint32)
    quads = []
    for images in kind_images.values():
        for im in images:
            packed = _rgb8(im)
            c01 = np.roll(packed, -1, axis=1)
            c10 = np.roll(packed, -1, axis=0)
            c11 = np.roll(c10, -1, axis=1)
            quads.append(np.stack([packed, c01, c10, c11],
                                  axis=-1).reshape(-1, 4))
    return np.concatenate(quads) if quads else np.zeros((1, 4), np.uint32)


_STAGE_HB = 128  # rows of one lane window of the JAX package's staged atlas


def _stage_file_textures(obj_tex, obj_tex_nm, tex_ims, nm_ims):
    """The JAX package's staging markers for file-backed textures
    (pathtracer_tpu.scene.pack._stage_file_textures): an entry whose desc
    is None and whose image fits the caps becomes ("__staged__",
    base_lane, w, h), w and h those of the image or of its mip. The TPU
    kernel fetches such a texture from a VMEM atlas; this package's
    kernel does not read the markers and samples the full-resolution pool.
    They are kept because they decide default_tile, and with it the
    random stream and the checkpoint layout. Same knobs: PT_TEX_STAGE=0
    disables, PT_TEX_STAGE_AREA and PT_TEX_STAGE_LANES cap, images over
    the area cap take the mip size below PT_TEX_MIP_AREA unless
    PT_TEX_MIP=0. Only the sizes are computed; no atlas is built."""
    if os.environ.get("PT_TEX_STAGE", "1") == "0":
        return obj_tex, obj_tex_nm
    max_area = int(os.environ.get("PT_TEX_STAGE_AREA", str(256 * 256)))
    max_lanes = int(os.environ.get("PT_TEX_STAGE_LANES", "4096"))
    mip_enabled = os.environ.get("PT_TEX_MIP", "1") != "0"
    mip_area = int(os.environ.get("PT_TEX_MIP_AREA", str(128 * 128)))
    # unique file-backed images, in first-use order
    order = {}
    for entries, ims in ((obj_tex, tex_ims), (obj_tex_nm, nm_ims)):
        for (_slot, desc, _w, _h, _sx, _sy), im in zip(entries, ims):
            if desc is None and im is not None:
                order.setdefault(id(im), (int(im.shape[0]),
                                          int(im.shape[1])))
    staged = {}
    off = 0                       # within-color-plane lane offset
    for key, (h, w) in order.items():
        if h * w > max_area and mip_enabled:
            # the shape of each box-filtered 2x2 level (pack._mip2: an odd
            # row or column is edge-replicated first)
            while h * w > mip_area and h > 1 and w > 1:
                h, w = -(-h // 2), -(-w // 2)
        hb = -(-h // _STAGE_HB)
        if h * w > max_area or 3 * (off + hb * w) > max_lanes:
            continue
        staged[key] = ("__staged__", off, w, h)
        off += hb * w

    def upgrade(entries, ims):
        return [(slot, staged[id(im)]
                 if desc is None and im is not None and id(im) in staged
                 else desc, w, h, sx, sy)
                for (slot, desc, w, h, sx, sy), im in zip(entries, ims)]

    return upgrade(obj_tex, tex_ims), upgrade(obj_tex_nm, nm_ims)


def leaf_size_for(objects: Sequence[Shape]) -> int:
    """The BVH leaf size pack_scene packs `objects` at: PT_BVH_LEAF when
    set, else 4 for a scene with meshes, whatever their size, and 16 for
    one without (no walk reads it there).

    The JAX package's rule, 32 for meshes of up to 8000 triangles in all
    and 16 above, was swept on the TPU's packet walk, where a leaf is one
    vector operation over the lanes. On the card each thread walks its
    own ray and tests a leaf's slots one after the other, so a small leaf
    tests fewer triangles that a nearer one in the same leaf hides, for a
    few more node tests. Measured on the H100 at 1280x960x8 spp (PERF.md
    §6), leaf 4 beat leaf 32 on `teapot` (1472 triangles) and leaf 16 on
    the 16640-triangle size-check mesh by 8-11%, and 8 and 16 lay in
    between."""
    if os.environ.get("PT_BVH_LEAF"):
        return int(os.environ["PT_BVH_LEAF"])
    has_mesh = any(isinstance(s, Group) and s.n_triangles()
                   for s in objects)
    return 4 if has_mesh else 16


def pack_scene(
    objects: Sequence[Shape],
    device,
    leaf_size: Optional[int] = None,
    max_objects: Optional[int] = None,
    textures: Sequence[np.ndarray] = (),
    sphere_textures: Sequence[np.ndarray] = (),
    cube_textures: Sequence[np.ndarray] = (),
    dtype=torch.float32,
) -> Tuple[SceneArrays, SceneMeta]:
    """Pack a scene onto `device`, its float fields in `dtype` (float32;
    float64 for the wavefront's f64 renders).

    The BVH leaf size is `leaf_size`, else leaf_size_for(objects). Octant
    node copies are built unless PT_OCTANT=0. A textured object's
    primitive type selects its image list (plane: `textures`, sphere:
    `sphere_textures`, box: `cube_textures`; tracer.cl:1077-1093); normal
    maps are planar only (tracer.cl:907-911)."""
    n = len(objects)
    no = max_objects or max(16, n)
    if n > no:
        raise ValueError(f"{n} objects > padded capacity {no}")

    if leaf_size is None:
        leaf_size = leaf_size_for(objects)

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
    is_tex = np.zeros(no, dtype=np.int32)
    tex_idx = np.zeros(no, dtype=np.int32)
    tex_scale = np.ones((no, 2))
    is_tex_nm = np.zeros(no, dtype=np.int32)
    tex_idx_nm = np.zeros(no, dtype=np.int32)
    tex_scale_nm = np.ones((no, 2))

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
        if m.textured:
            is_tex[i] = 1
            tex_idx[i] = m.texture_id
            tex_scale[i] = (m.texture_scale_x, m.texture_scale_y)
        if m.textured_nm:
            is_tex_nm[i] = 1
            tex_idx_nm[i] = m.texture_id_nm
            tex_scale_nm[i] = (m.texture_scale_x_nm, m.texture_scale_y_nm)
        if isinstance(s, Cylinder):
            min_y[i] = s.min_y
            max_y[i] = s.max_y
        elif isinstance(s, Group):
            if not s.n_triangles():
                # a group with no triangles contributes nothing (the
                # reference skips childCount==0 groups, tracer.cl:617)
                obj_type[i] = NONE_TYPE
                continue
            s.bounds()
            bb_min[i] = s.bounding_box.min[:3]
            bb_max[i] = s.bounding_box.max[:3]
            soup = s.soup
            if soup is not None:
                # a parsed model's arrays, with no Triangle objects
                pool, root, end = build_bvh_arrays(
                    soup.p1, soup.p2, soup.p3, soup.n1, soup.n2, soup.n3,
                    soup.color, leaf_size=leaf_size, into=pool)
            else:
                pool, root, end = build_bvh(s.all_triangles(),
                                            leaf_size=leaf_size, into=pool)
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

    # the texel pool and each textured object's (base, w, h) in it, and the
    # per-object texture records of SceneMeta (the JAX package's obj_tex:
    # (slot, procedural descriptor or None, w, h, sx, sy))
    kind_images = {"planar": list(textures), "sphere": list(sphere_textures),
                   "cube": list(cube_textures)}
    tex_pool, pool_tables = _build_texel_pool(kind_images)
    tex_pool_quad = _build_quad_pool(kind_images)
    kind_of_type = {PLANE: "planar", SPHERE: "sphere", BOX: "cube"}
    pool_base = np.zeros(no)
    pool_w = np.ones(no)
    pool_h = np.ones(no)
    pool_nm_base = np.zeros(no)
    pool_nm_w = np.ones(no)
    pool_nm_h = np.ones(no)
    obj_tex, obj_tex_nm, obj_tex_im, obj_tex_nm_im = [], [], [], []

    def tex_record(i, ims, idx, scale):
        im = ims[idx] if idx < len(ims) else None
        return ((i, getattr(im, "proc", None) if im is not None else None,
                 int(im.shape[1]) if im is not None else 1,
                 int(im.shape[0]) if im is not None else 1,
                 float(scale[0]), float(scale[1])), im)

    for i in range(n):
        kind = kind_of_type.get(int(obj_type[i]))
        entries = pool_tables.get(kind, [])
        if is_tex[i] and tex_idx[i] < len(entries):
            pool_base[i], pool_w[i], pool_h[i] = entries[tex_idx[i]]
        if is_tex_nm[i] and tex_idx_nm[i] < len(pool_tables["planar"]):
            (pool_nm_base[i], pool_nm_w[i],
             pool_nm_h[i]) = pool_tables["planar"][tex_idx_nm[i]]
        if is_tex[i] and kind is not None:
            rec, im = tex_record(i, kind_images[kind], tex_idx[i],
                                 tex_scale[i])
            obj_tex.append(rec)
            obj_tex_im.append(im)
        if is_tex_nm[i] and int(obj_type[i]) == PLANE:
            rec, im = tex_record(i, kind_images["planar"], tex_idx_nm[i],
                                 tex_scale_nm[i])
            obj_tex_nm.append(rec)
            obj_tex_nm_im.append(im)
    obj_tex, obj_tex_nm = _stage_file_textures(
        obj_tex, obj_tex_nm, obj_tex_im, obj_tex_nm_im)

    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def f(a):
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np_dtype)).to(device)

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
        is_textured=i32(is_tex),
        texture_index=i32(tex_idx),
        texture_scale=f(tex_scale),
        is_textured_nm=i32(is_tex_nm),
        texture_index_nm=i32(tex_idx_nm),
        texture_scale_nm=f(tex_scale_nm),
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
        tex_planar=f(_pack_texture_atlas(textures)),
        tex_sphere=f(_pack_texture_atlas(sphere_textures)),
        tex_cube=f(_pack_texture_atlas(cube_textures)),
        tex_pool_u32=u32(tex_pool),
        tex_pool_quad_u32=u32(tex_pool_quad),
        tex_base=f(pool_base),
        tex_w=f(pool_w),
        tex_h=f(pool_h),
        tex_nm_base=f(pool_nm_base),
        tex_nm_w=f(pool_nm_w),
        tex_nm_h=f(pool_nm_h),
        tex_staged=f(np.zeros((8, 128))),
    )
    textured_types = sorted(
        {int(obj_type[i]) for i, s in enumerate(objects)
         if s.material.textured and obj_type[i] != NONE_TYPE})
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
        textured_types=tuple(textured_types),
        has_normal_maps=any(s.material.textured_nm for s in objects),
        light_indices=lights,
        octant_orders=bool(octant),
        tri_uniform_color=uni_color,
        obj_tex=tuple(obj_tex),
        obj_tex_nm=tuple(obj_tex_nm),
    )
    return arrays, meta


def from_jax_scene(arrays, meta, device) -> Tuple[SceneArrays, SceneMeta]:
    """Carry a scene packed by the JAX package over to this one.

    `arrays` is the JAX package's SceneArrays with every field converted
    to numpy by the caller (a NamedTuple or a mapping of field name to
    array); `meta` is its SceneMeta. Returns this package's SceneArrays on
    `device` and SceneMeta. Mesh pools, group BVH ranges, octant copies,
    the texel pool and the texture fields carry over as they are, except
    the staged atlas, which this package does not read: it becomes the
    [8, 128] placeholder. Non-finite group bounds raise."""
    fields = arrays._asdict() if hasattr(arrays, "_asdict") else dict(arrays)
    fields["tex_staged"] = np.zeros((8, 128), np.float32)
    out_meta = SceneMeta(**{
        fd.name: getattr(meta, fd.name)
        for fd in dataclasses.fields(SceneMeta)})
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


# --- trainable texels ---------------------------------------------------------
#
# The differentiable render trains an f32 copy of the texel pool, [T, 3].
# Texels of the textures that the JAX package stages (the "__staged__"
# markers of SceneMeta.obj_tex) take gradients; the JAX package trains the
# same texels in its staged atlas [128, Ltot], where texel (y, x), color c
# of a texture staged at lane `base` with width w sits at row y % 128, lane
# c*P + base + (y // 128)*w + x, P = Ltot / 3 (its scene/pack.py
# _stage_file_textures, "global color-outer" layout).

_INV255 = float(np.float32(1.0 / 255.0))


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def is_staged(desc) -> bool:
    """Whether a texture record's descriptor is a staging marker."""
    return isinstance(desc, tuple) and bool(desc) and desc[0] == "__staged__"


def decode_rgb8(q: torch.Tensor):
    """The pool's int32 texels q (r | g << 8 | b << 16) decoded to f32
    (r, g, b) as q * f32(1/255), the kernel's decode."""
    return [((q >> s) & 255).to(torch.float32) * _INV255 for s in (0, 8, 16)]


def staged_objects(meta: SceneMeta) -> Tuple[int, ...]:
    """The objects whose color texture takes texel gradients: those whose
    obj_tex record carries a staging marker."""
    return tuple(sorted({slot for (slot, desc, *_r) in meta.obj_tex
                         if is_staged(desc)}))


def texel_params(scn: SceneArrays) -> torch.Tensor:
    """The trainable texels: the rgb8 pool decoded to f32 [T, 3] on the
    pool's device, q * f32(1/255) as the kernel's fetch decodes a byte, so
    a render from these texels is the rgb8 render bit for bit."""
    return torch.stack(decode_rgb8(scn.tex_pool_u32.view(torch.int32)),
                       dim=1).contiguous()


def trainable_texels(scn: SceneArrays, meta: SceneMeta) -> torch.Tensor:
    """bool [T] on the pool's device: the texels of staged_objects'
    textures, the only ones with nonzero gradients. A texture the JAX
    package stages as a mip (an over-cap image) trains here at full
    resolution; it has no texel-for-texel counterpart in the atlas."""
    base, w, h = (_np(a) for a in (scn.tex_base, scn.tex_w, scn.tex_h))
    mask = np.zeros(scn.tex_pool_u32.shape[0], bool)
    for slot in staged_objects(meta):
        b = int(base[slot])
        mask[b:b + int(w[slot]) * int(h[slot])] = True
    return torch.from_numpy(mask).to(scn.tex_pool_u32.device)


def _atlas_map(meta: SceneMeta, base, w, h):
    """(pool index, atlas row, lane within a color plane), int64 [N] each,
    of every texel of the textures staged at their full size (a mip-staged
    texture's atlas holds other texels, so it has no entry). base, w, h:
    the per-object pool coordinates (SceneArrays.tex_base/_w/_h)."""
    seen, parts = set(), []
    for (slot, desc, *_r) in meta.obj_tex:
        if not is_staged(desc):
            continue
        _, lane, aw, ah = desc
        b, tw, th = int(base[slot]), int(w[slot]), int(h[slot])
        if (aw, ah) != (tw, th) or (b, lane) in seen:
            continue
        seen.add((b, lane))
        i = np.arange(tw * th, dtype=np.int64)
        y, x = np.divmod(i, tw)
        parts.append((b + i, y % _STAGE_HB,
                      lane + (y // _STAGE_HB) * tw + x))
    if not parts:
        return tuple(np.zeros(0, np.int64) for _ in range(3))
    return tuple(np.concatenate(c) for c in zip(*parts))


def atlas_to_texels(atlas, scn: SceneArrays, meta: SceneMeta,
                    texels: torch.Tensor = None) -> torch.Tensor:
    """The JAX package's staged atlas [128, Ltot] (numpy or a tensor) as
    this package's texels [T, 3]: each full-size staged texel takes the
    atlas's value; every other texel keeps `texels`' value (default:
    texel_params, the decoded pool). The atlas decodes a byte as
    f32(q) / f32(255), one ulp off the pool's decode on 126 of 256 values,
    so carried-over texels make both packages compute the same thing."""
    out = (texel_params(scn) if texels is None else texels).detach().clone()
    atlas = _np(atlas)
    plane = atlas.shape[1] // 3
    pi, row, lane = _atlas_map(meta, *(_np(a) for a in (
        scn.tex_base, scn.tex_w, scn.tex_h)))
    vals = np.stack([atlas[row, c * plane + lane] for c in range(3)], axis=1)
    out[torch.from_numpy(pi).to(out.device)] = torch.from_numpy(
        np.ascontiguousarray(vals, np.float32)).to(out.device)
    return out


def texels_to_atlas(texels: torch.Tensor, scn: SceneArrays, meta: SceneMeta,
                    lanes: int) -> np.ndarray:
    """The transpose of atlas_to_texels' gather: the full-size staged
    texels of [T, 3] (values or gradients) summed into an [128, lanes]
    float64 atlas in the JAX package's layout (lanes = its Ltot; zero
    elsewhere). Each atlas texel has one pool texel in the repository's
    scenes, so for values this is the inverse map."""
    t = _np(texels).astype(np.float64)
    plane = lanes // 3
    pi, row, lane = _atlas_map(meta, *(_np(a) for a in (
        scn.tex_base, scn.tex_w, scn.tex_h)))
    out = np.zeros((_STAGE_HB, lanes), np.float64)
    for c in range(3):
        np.add.at(out, (row, c * plane + lane), t[pi, c])
    return out

