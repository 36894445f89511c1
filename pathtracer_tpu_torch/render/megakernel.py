"""Forward megakernel for scenes of primitives, triangle meshes and
textures: tables, tile layout, the counter-hash PRNG, the BVH walk, the UV
maps and texel fetch, next-event estimation, and the CUDA kernel with its
plain PyTorch version; and the intersect-only kernel.

Counterpart of pathtracer_tpu.render.pallas_kernel: the host table
builders and the pixel-to-tile layout keep their names and outputs (numpy,
bit-identical), `trace_tiles` runs the whole sample loop x bounce loop per
tile slot (with one shadow ray per light at each bounce under cfg.nee),
`render_megakernel` is the one-call render (the counterpart of
`render_pallas`), and `intersect_batch` finds the nearest hit of a flat
batch of rays over the whole scene (the counterpart of the JAX package's
intersect-only kernel). `_nearest_hit` (and csrc/megakernel.cu's
nearest_hit) is the one whole-scene query behind the bounce, the shadow
rays and intersect_batch.

Textures: the JAX kernel computes procedural texels in the kernel and
fetches small file images by one-hot matmuls from a staged atlas, because
a TPU lane cannot gather. Here every texture, procedural or file, small or
large, is one 4-tap bilinear fetch from the full-resolution rgb8 texel
pool (`sample_pool`), with the object's (base, w, h) from the texture
table (`build_tex_table`); its REPEAT wrap takes no division where that
gives the JAX kernel's wrap bit for bit (`wrap_fast`, `wrap_is_fast`),
and the JAX formula elsewhere. The UV maps are the JAX kernel's,
operation for operation (`_spherical_uv`, `_cube_uv`). The differentiable
render fetches from f32 texels instead (`tex_texels`, `sample_texels`: the
pool decoded, then trained), which with the decoded pool give the rgb8
render bit for bit.

Meshes: the JAX kernel walks the skip-link BVH with one node pointer per
(8, 512) packet (`_packet_traverse`). Here every ray walks it alone
(`traverse_reference`, and the GROUP case of csrc/megakernel.cu), on the
node copy of its own direction octant. A child box lies inside its
parent's, so the per-ray walk tests exactly the leaves the packet walk
tests for that ray; only the order differs, which changes the result only
on exact-t ties between two triangles. The JAX package's walk knobs select
the kernel's warp-packet walks instead (`mesh_walk`: the 32 lanes of a
warp share one node pointer, on the octant copy of the block's or the
warp's majority), with the dual-basis leaf tests, the six plane dots on
the tensor cores (PT_TRAVERSAL=mxu, `mxu_plane_arrays`) or no leaf tests
(PT_ABLATE_LEAF=1).

`trace_tiles` launches `csrc/megakernel.cu` for CUDA tensors and runs
`trace_tiles_reference`, the plain vectorised version, for CPU tensors.
Both draw from the murmur3 counter hash that the JAX kernel uses in
interpret mode (`pallas_kernel._prng_seed/_uniform`), keyed on (seed,
tile, draw id, sample, bounce, slot), so with the same seed vector, tile
and layout all three trace the same paths.

`finish_frame` turns a frame's slot sums into its image on the card: the
float64 sum of each pixel's sample replicas, the divide and the f32 cast,
bit for bit what `untile_image` and the host's divide give (which it runs
itself off the card).
"""
from __future__ import annotations

import ctypes
import math
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import RenderConfig
from ..scene.pack import SceneArrays, SceneMeta, _np, decode_rgb8, is_staged
from ..scene.shapes import BOX, CYLINDER, GROUP, PLANE, SPHERE
from . import _build

# Object-table column layout (per object row), as in the JAX package:
#   0-11  inverse (3x4 row-major)
#   12-23 inverse-transpose (3x4 row-major)
#   24-26 color rgb
#   27-29 emission rgb
#   30    refractive index
#   31    reflectivity
#   32    min_y
#   33    max_y
#   34-36 group bbox min (local space; GROUP objects only)
#   37-39 group bbox max
#   40-42 forward-transform translation (world light origin; NEE)
#   43    light scale = max diagonal of the forward transform
#   44    forward transform [0,0] (NEE attenuation heuristic)
_OBJ_COLS = 45

# Camera vector layout:
#   0-11 inverse (3x4 row-major), 12 pixel_size, 13 half_width,
#   14 half_height, 15 aperture, 16 focal_length
_CAM_COLS = 17

# The mesh tables are 16-byte records, which the kernel reads as float4
# (the TPU layout's 64-byte node and 96-byte slot, four slots a row, put
# padding and shading data into every cache line the walk pulled in).
# Node rows (one skip-link BVH node per row, two float4):
#   0-2 bbmin, 3 tri_start of a leaf (exact f32 int) or -1 for an inner
#   node (the leaf flag), 4-6 bbmax, 7 exit
_NODE_COLS = 8
# Triangle test rows, one slot per row (three float4, dual basis):
#   0-2 p1, 3-5 Ng (= e1 x e2, unnormalized), 6-8 U, 9-11 V
#   (U.e1 = 1, U.e2 = 0; V.e1 = 0, V.e2 = 1; both in-plane)
_TRI_COLS = 12
# Triangle shading rows, one slot per row in a table of their own (three
# float4), read for the winning slot alone:
#   0-2 n1, 3-5 d21 (= n2-n1), 6-8 d31 (= n3-n1), 9-11 color
_SHADE_COLS = 12
# Under MXU leaves (PT_TRAVERSAL=mxu) the test table carries, after its Ns
# rows, the leaves' plane tiles in the layout of mxu_fragments ([n_leaves,
# mxu_tiles(K), 32] f32: each the B fragment of one m8n8k4 DMMA, eight
# columns of the half of q = [o, 1, d, 0] that their groups read), flat and
# zero-padded to whole rows (_mxu_rows); the payload (normals, color) is
# the shading table's.

_BIG = 1e30
_INV24 = float(2.0 ** -24)
_M32 = 0xFFFFFFFF

# the counts' names of the object types, and the counts of the shadow
# query (_light_visible)
TYPE_NAMES = {PLANE: "plane", SPHERE: "sphere", CYLINDER: "cylinder",
               BOX: "box", GROUP: "group"}
QUERY_COUNTS = ("shadow_light_missed", "shadow_occluded", "query_nodes",
                "query_slots", *(f"query_{n}" for n in TYPE_NAMES.values()))

# Texture-table column layout (per object row), [No, _TEX_COLS] f32:
#   0     color texture flag (1 = textured; the object's type picks the UV
#         map: plane (lx*sx, lz*sy), sphere spherical, box cube cross)
#   1-3   base, w, h of the color texture in the texel pool
#   4-5   sx, sy (plane UV scale)
#   6     normal-map flag (planes only)
#   7-9   base, w, h of the normal map in the pool
#   10-11 sxn, syn
_TEX_COLS = 12


# --- host tables and layout ------------------------------------------------

def build_scene_table(scn: SceneArrays, meta: SceneMeta) -> np.ndarray:
    """[No, _OBJ_COLS] float32 host-side object table."""
    n = meta.n_objects
    out = np.zeros((n, _OBJ_COLS), dtype=np.float32)
    inv = _np(scn.inverse).astype(np.float32)
    invt = _np(scn.inverse_transpose).astype(np.float32)
    out[:, 0:12] = inv[:n, :3, :].reshape(n, 12)
    out[:, 12:24] = invt[:n, :3, :].reshape(n, 12)
    out[:, 24:27] = _np(scn.color)[:n]
    out[:, 27:30] = _np(scn.emission)[:n]
    out[:, 30] = _np(scn.refractive_index)[:n]
    out[:, 31] = _np(scn.reflectivity)[:n]
    out[:, 32] = _np(scn.min_y)[:n]
    out[:, 33] = _np(scn.max_y)[:n]
    out[:, 34:37] = _np(scn.bb_min)[:n]
    out[:, 37:40] = _np(scn.bb_max)[:n]
    tr = _np(scn.transform).astype(np.float32)
    out[:, 40:43] = tr[:n, :3, 3]
    out[:, 43] = np.maximum(np.maximum(tr[:n, 0, 0], tr[:n, 1, 1]),
                            tr[:n, 2, 2])
    out[:, 44] = tr[:n, 0, 0]
    return out


class Walk(NamedTuple):
    """A mesh walk of the kernel: `walk` is "thread" (each thread walks
    its own ray on its own octant copy), "block" (the 32 lanes of a warp
    share one node pointer, on the octant copy of the thread block's
    majority) or "warp" (the same, on the warp's majority); `leaf` is
    "simt" (the dual-basis tests, a lane per ray), "mma" (the six plane
    dots of a leaf's triangles against the warp's 32 rays on the tensor
    cores) or "none" (the node walk alone: no triangle is ever hit)."""
    walk: str = "thread"
    leaf: str = "simt"


WALK_CODES = {"thread": 0, "block": 1, "warp": 2}
LEAF_CODES = {"simt": 0, "mma": 1, "none": 2}


def mesh_walk() -> Walk:
    """The walk the JAX package's knobs select in the forward kernels (its
    _packet_traverse :1395-1406, the per-chunk walks :1992-2008 and
    traversal_mode :227; the gradient kernel's is grad_walk's):
    PT_SUBPACKET=1 or 2 (one gated walk over the tile there) -> "block";
    =3 (an independent walk per 128-lane chunk) -> "warp";
    PT_TRAVERSAL=mxu -> "block" with "mma" leaves, whatever PT_SUBPACKET
    says (as there); PT_ABLATE_LEAF=1 -> "none" leaves on the walk the
    others select (the MXU walk has no ablation, as there). Unset: the
    per-thread walk. PT_SUBPACKET=1 and =2 are aliases here: the JAX
    package's two gatings (lax.cond, scratch) are one per-warp gate on the
    card.

    The packet walks and the tensor-core leaves measured slower than the
    per-thread walk on every workload timed so far (PERF.md §6): on
    `teapot` at 1280x960x8 spp and leaf 4, in turns on an NVIDIA H100
    80GB HBM3 at 700 W, the per-thread walk 1.49 ms, packet mode 2 1.70
    ms, mode 3 1.65 ms, the tensor-core leaves 1.93 ms after their
    redesign (2.44 ms before it). They are kept as the ported
    counterparts of the JAX package's walks and as measurement tools."""
    if os.environ.get("PT_TRAVERSAL") == "mxu":
        return Walk("block", "mma")
    sp = os.environ.get("PT_SUBPACKET", "")
    walk = {"1": "block", "2": "block", "3": "warp"}.get(sp, "thread")
    leaf = "none" if os.environ.get("PT_ABLATE_LEAF") == "1" else "simt"
    return Walk(walk, leaf)


_PER_THREAD = Walk()


def scene_walk(meta: SceneMeta) -> Walk:
    """The walk a launch on the scene takes: mesh_walk() for a scene with
    meshes, the per-thread walk (the primitives' kernel) otherwise. Read
    once a call, and handed to the table check and the launch."""
    return mesh_walk() if meta.has_groups else _PER_THREAD


_WARP = 32       # lanes of a warp: the packet of the "block"/"warp" walks
_BLOCK = 128     # threads of a block (kThreads of csrc/megakernel.cu)


def walk_groups(n: int, walk: Walk, device=None):
    """(octant group, packet) ids of n consecutive slots or rays under
    `walk`, as the kernel forms them: the thread block's 128 slots, or
    the warp's 32, share an octant copy; a warp's 32 share a node pointer.
    (None, None) for the per-thread walk."""
    if walk.walk == "thread":
        return None, None
    i = torch.arange(n, device=device)
    return i // (_BLOCK if walk.walk == "block" else _WARP), i // _WARP


def grad_walk() -> Walk:
    """The walk the JAX package's knobs select in the gradient kernel,
    whose replay takes its walk from _packet_traverse alone (pallas_grad.py
    :361-376): PT_SUBPACKET=1 or 2 (its gated walks over the tile's
    128-lane chunks, pallas_kernel.py:1395-1406) -> "block", as mesh_walk
    gives; =3 -> the per-thread walk (mode 3's per-chunk walks are the
    forward kernel's, :1984-2008, so the JAX gradient kernel runs its
    default walk under it); PT_ABLATE_LEAF=1 -> "none" leaves on the walk
    the other selects (pallas_kernel.py:1487-1493). PT_TRAVERSAL=mxu
    raises, as the JAX package's differentiable kernel refuses it
    (pallas_grad.py:1151). grad_tiles, its plain version and the
    differentiable renders' checks read the knobs here."""
    if os.environ.get("PT_TRAVERSAL") == "mxu":
        raise NotImplementedError(
            "differentiable megakernel replay is classic-traversal only "
            "(tables are classic layout); unset PT_TRAVERSAL")
    sp = os.environ.get("PT_SUBPACKET", "")
    walk = "block" if sp in ("1", "2") else "thread"
    leaf = "none" if os.environ.get("PT_ABLATE_LEAF") == "1" else "simt"
    return Walk(walk, leaf)


def grad_scene_walk(meta: SceneMeta) -> Walk:
    """scene_walk's counterpart for the gradient kernel: grad_walk() for a
    scene with meshes, the per-thread walk otherwise."""
    return grad_walk() if meta.has_groups else _PER_THREAD


def mxu_plane_arrays(scn: SceneArrays, meta: SceneMeta
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The per-leaf blocks of the JAX package's MXU leaf machine
    (pallas_kernel._mxu_plane_arrays :247, in numpy f32 with its
    operations): a [n_leaves, 6K, 8] f32, the six plane rows of each of a
    leaf's K triangles against q = [o, 1, d, 0] (groups den, num_t, ou,
    du, ov, dv of K rows each), and pay [n_leaves, 16, K] f32 (n1, n2-n1,
    n3-n1, color, 4 zero rows). The kernel reads `a` in the layout of
    mxu_fragments; pay holds the classic table's payload columns."""
    K = meta.leaf_size
    f = lambda a: np.asarray(_np(a), dtype=np.float32)  # noqa: E731
    p1, e1, e2 = f(scn.tri_p1), f(scn.tri_e1), f(scn.tri_e2)
    n1, n2, n3, color = (f(scn.tri_n1), f(scn.tri_n2), f(scn.tri_n3),
                         f(scn.tri_color))
    ns = p1.shape[0]
    if ns % K:
        raise ValueError(f"{ns} triangle slots are not whole leaves of {K}")
    nl = ns // K
    ng = np.cross(e1, e2)
    l2 = (ng * ng).sum(axis=1, keepdims=True)
    safe = np.where(l2 > 0.0, l2, 1.0)
    uu = np.where(l2 > 0.0, np.cross(e2, ng) / safe, np.zeros_like(ng))
    vv = np.where(l2 > 0.0, np.cross(ng, e1) / safe, np.zeros_like(ng))
    z1 = np.zeros((ns, 1), dtype=np.float32)
    z4 = np.zeros((ns, 4), dtype=np.float32)

    def odot(vec):  # -(o-P1).vec as [vec, +P1.vec] on q[0:4]
        return np.concatenate(
            [vec, -(p1 * vec).sum(axis=1, keepdims=True), z4], axis=1)

    def ddot(vec):  # d.vec on q[4:7]
        return np.concatenate([z4, vec, z1], axis=1)

    groups = [ddot(ng),
              np.concatenate([-ng, (p1 * ng).sum(axis=1, keepdims=True), z4],
                             axis=1),
              odot(uu), ddot(uu), odot(vv), ddot(vv)]
    a = np.stack(groups, axis=1)                              # [Ns, 6, 8]
    a = a.reshape(nl, K, 6, 8).transpose(0, 2, 1, 3).reshape(nl, 6 * K, 8)
    pay = np.concatenate([n1, n2 - n1, n3 - n1, color], axis=1)
    pay = pay.reshape(nl, K, 12).transpose(0, 2, 1)
    pay = np.concatenate([pay, np.zeros((nl, 4, K), dtype=np.float32)],
                         axis=1)
    return a, pay


# The six plane groups of an MXU block, in order: which half of q = [o, 1,
# d, 0] each one reads (1: the direction half, 0: the origin half)
_MXU_D_HALF = (1, 0, 0, 1, 0, 1)


# A leaf of at most _MXU_PACK_LEAF triangles packs two plane groups of one
# half of q into each tile, triangle c's in columns (2c, 2c + 1): the
# groups of the four tiles' column pairs (None: zero columns)
_MXU_PACK_LEAF = 4
_MXU_PACKED = ((0, 3), (5, None), (1, 2), (4, None))


def mxu_tiles(K: int) -> int:
    """Plane tiles a leaf of K triangles has (mxu_fragments)."""
    return 4 if K <= _MXU_PACK_LEAF else 6 * -(-K // 8)


def mxu_fragments(a: np.ndarray) -> np.ndarray:
    """The kernel's layout of the MXU blocks `a` [n_leaves, 6K, 8]:
    [n_leaves, mxu_tiles(K), 32] f32, each tile the B fragment of one
    m8n8k4 DMMA whose A is 8 rays: lane l holds coefficient l % 4 of column
    l // 4, of the half of q = [o, 1, d, 0] its group reads (the other half
    is never stored), so a warp loads a tile in one 128-byte transaction.
    K > 4: tile g * ceil(K/8) + kt holds group g of triangles 8 kt .. 8 kt
    + 7 as its columns (0 past the K rows). K <= 4: four tiles of two
    groups each (_MXU_PACKED), triangle c's in columns 2c and 2c + 1 (0
    past the K triangles), so each lane's DMMAs give all six dots of one
    (ray, triangle) pair and no column is padding but the two unpaired."""
    nl, six_k, _ = a.shape
    K = six_k // 6
    rows = a.reshape(nl, 6, K, 8)
    if K <= _MXU_PACK_LEAF:
        cols = np.zeros((nl, 4, 4, 2, 4), dtype=np.float32)
        for tile, pair in enumerate(_MXU_PACKED):
            for j, g in enumerate(pair):
                if g is not None:
                    h = _MXU_D_HALF[g]
                    cols[:, tile, :K, j] = rows[:, g, :, 4 * h:4 * h + 4]
        return np.ascontiguousarray(cols.reshape(nl, 4, 32))
    kt = -(-K // 8)
    cols = np.zeros((nl, 6, kt * 8, 4), dtype=np.float32)
    for g, h in enumerate(_MXU_D_HALF):
        cols[:, g, :K] = rows[:, g, :, 4 * h:4 * h + 4]
    return np.ascontiguousarray(cols.reshape(nl, 6 * kt, 32))


def mxu_groups(frag, K: int):
    """The plane rows of tiles `frag` [..., mxu_tiles(K), 32] (mxu_fragments):
    [..., 6, K, 4], group g's coefficients of each triangle on the half of
    q the group reads."""
    lead = frag.shape[:-2]
    if K <= _MXU_PACK_LEAF:
        cols = frag.reshape(*lead, 4, 4, 2, 4)
        at = {g: (tile, j) for tile, pair in enumerate(_MXU_PACKED)
              for j, g in enumerate(pair) if g is not None}
        return torch.stack([cols[..., at[g][0], :K, at[g][1], :]
                            for g in range(6)], dim=-3)
    return frag.reshape(*lead, 6, -1, 4)[..., :K, :]


def build_mesh_tables(scn: SceneArrays, meta: SceneMeta,
                      traversal: str = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The mesh pools for the walk: (nodes, tris, shade), f32.

    nodes: [Nn, _NODE_COLS], one skip-link BVH node per row (all nine
    copies when the scene has octant orders). tris: [Ns, _TRI_COLS], each
    triangle slot's test record (with the MXU fragments after its rows
    under MXU leaves). shade: [Ns, _SHADE_COLS], each slot's shading record.
    Indices are stored as f32 (pool sizes < 2^24, exact). Scenes without
    meshes get one zero row of each. Every walk reads these; the MXU
    leaves read mxu_fragments beside them (traversal is accepted for the
    JAX package's signature: "classic" or "mxu"; None follows
    PT_TRAVERSAL)."""
    if not meta.has_groups:
        return (np.zeros((1, _NODE_COLS), dtype=np.float32),
                np.zeros((1, _TRI_COLS), dtype=np.float32),
                np.zeros((1, _SHADE_COLS), dtype=np.float32))
    if traversal not in (None, "classic", "mxu"):
        raise ValueError(f"traversal {traversal!r} is not classic or mxu")
    if traversal is None:
        traversal = "mxu" if mesh_walk().leaf == "mma" else "classic"
    nn = int(_np(scn.node_bb_min).shape[0])
    nodes = np.zeros((nn, _NODE_COLS), dtype=np.float32)
    nodes[:, 0:3] = _np(scn.node_bb_min)
    nodes[:, 3] = np.where(_np(scn.node_is_leaf) > 0.5,
                           _np(scn.node_tri_start), -1.0)
    nodes[:, 4:7] = _np(scn.node_bb_max)
    nodes[:, 7] = _np(scn.node_exit)

    # dual-basis precompute, in f32 exactly as the JAX package: Ng = e1 x e2
    # and the in-plane reciprocal basis U = e2 x Ng / |Ng|^2, V = Ng x e1 /
    # |Ng|^2, so the barycentrics are two affine dot products. Degenerate
    # (padding) slots have Ng = 0, fail the kernel's |d.Ng| >= eps test, and
    # get zero U/V here.
    e1 = _np(scn.tri_e1).astype(np.float32)
    e2 = _np(scn.tri_e2).astype(np.float32)
    ng = np.cross(e1, e2)
    l2 = (ng * ng).sum(axis=1, keepdims=True)
    safe = np.where(l2 > 0.0, l2, 1.0)
    uu = np.where(l2 > 0.0, np.cross(e2, ng) / safe, 0.0)
    vv = np.where(l2 > 0.0, np.cross(ng, e1) / safe, 0.0)
    n1 = _np(scn.tri_n1)

    def table(*fields):
        return np.concatenate([np.asarray(f, dtype=np.float32)
                               for f in fields], axis=1)

    tris = table(_np(scn.tri_p1), ng, uu, vv)
    shade = table(n1, _np(scn.tri_n2) - n1, _np(scn.tri_n3) - n1,
                  _np(scn.tri_color))
    if traversal == "mxu":
        frag = mxu_fragments(mxu_plane_arrays(scn, meta)[0]).reshape(-1)
        frag = np.pad(frag, (0, _mxu_rows(meta) * _TRI_COLS - frag.size))
        tris = np.concatenate([tris, frag.reshape(-1, _TRI_COLS)])
    return nodes, tris, shade


def textures_computable(meta: SceneMeta) -> bool:
    """Whether the JAX package's TPU kernel can sample every texture of the
    scene (pallas_kernel.textures_computable): each carries a procedural
    program or a staging marker. This package's kernel fetches every
    texture from the pool, so supports_scene does not ask."""
    return all(desc is not None
               for (_slot, desc, _w, _h, _sx, _sy)
               in meta.obj_tex + meta.obj_tex_nm)


def staged_lanes(meta: SceneMeta) -> int:
    """Lane width of the JAX package's staged file-texture atlas
    (pallas_kernel.staged_lanes; 0 when nothing is staged): each staged
    texture spans ceil(h/128)*w lanes from its base, the plane pads to a
    128-lane multiple, and the atlas is three planes wide."""
    m = 0
    for (_slot, desc, _w, _h, _sx, _sy) in meta.obj_tex + meta.obj_tex_nm:
        if is_staged(desc):
            _, b, w, h = desc
            m = max(m, b + (-(-h // 128)) * w)
    return 3 * max(128, -(-m // 128) * 128) if m else 0


def supports_scene(meta: SceneMeta, scn: SceneArrays = None) -> bool:
    """Megakernel coverage: the four primitives and BVH triangle meshes of
    any leaf size (the JAX package's needs a multiple of the four slots of
    its triangle row; one slot a row here), with any texture (every one is
    fetched from the pool)."""
    return all(t in (PLANE, SPHERE, CYLINDER, BOX, GROUP)
               for t in meta.obj_types)


def has_textures(meta: SceneMeta) -> bool:
    """Whether any object samples a color texture or a normal map (a
    textured cylinder or mesh samples none, as in the JAX kernel)."""
    return bool(meta.obj_tex or meta.obj_tex_nm)


def build_tex_table(scn: SceneArrays, meta: SceneMeta) -> np.ndarray:
    """[No, _TEX_COLS] float32 per-object texture table: the flags and UV
    scales of meta.obj_tex / obj_tex_nm and the (base, w, h) of each
    texture in the full-resolution pool (not the staged or mip sizes that
    the JAX kernel samples). Bases are f32-exact: the pool stays below
    2^24 texels."""
    out = np.zeros((meta.n_objects, _TEX_COLS), dtype=np.float32)
    out[:, [2, 3, 8, 9]] = 1.0
    base, w, h = (_np(a) for a in (scn.tex_base, scn.tex_w, scn.tex_h))
    nbase, nw, nh = (_np(a) for a in (scn.tex_nm_base, scn.tex_nm_w,
                                      scn.tex_nm_h))
    for col, entries, (b, tw, th) in ((0, meta.obj_tex, (base, w, h)),
                                      (6, meta.obj_tex_nm, (nbase, nw, nh))):
        for (slot, _desc, _w, _h, sx, sy) in entries:
            out[slot, col:col + 6] = (1.0, b[slot], tw[slot], th[slot],
                                      sx, sy)
    return out


def texture_inputs(scn: SceneArrays, meta: SceneMeta, device) -> dict:
    """trace_tiles' texture keywords for a scene on `device`: {} for a
    scene without textures, else the pool as int32 (rgb8 texels stay below
    2^24, so the view keeps their values) and the texture table."""
    if not has_textures(meta):
        return {}
    return {"tex_pool": scn.tex_pool_u32.view(torch.int32).to(device)
            .contiguous(),
            "tex_table": torch.from_numpy(build_tex_table(scn, meta))
            .to(device)}


def default_tile(meta: SceneMeta) -> Tuple[int, int]:
    """Tile shape (S, L) that numbers the slots, as in the JAX package:
    (64, 256) for primitive scenes, (8, 512) for mesh scenes and for
    scenes with staged file textures (whose one-hot fetch the TPU unrolls
    per tile row). On the card the tile is only a numbering (one thread
    per slot); keeping it makes the random stream and the checkpoint
    layout match the JAX package."""
    if meta.has_groups or staged_lanes(meta):
        return (8, 512)
    return (64, 256)


def default_order(meta: SceneMeta) -> str:
    """Pixel->tile order: scanline for primitive scenes, compact blocks for
    mesh scenes; PT_TILE_ORDER overrides."""
    return os.environ.get(
        "PT_TILE_ORDER", "block" if meta.has_groups else "linear")


def default_pack_axis(meta: SceneMeta) -> str:
    """Tile axis carrying sample replicas ("row" | "chunk"); PT_PACK_AXIS
    overrides. Packing serves the mesh walk only."""
    v = os.environ.get("PT_PACK_AXIS")
    if v:
        return v
    return "chunk" if meta.has_groups else "row"


def clamp_pack(pack: int, S: int, L: int, pack_axis: str) -> int:
    """Largest packing factor <= pack the tile supports on the axis."""
    if pack_axis == "chunk":
        while pack > 1 and (L % pack or (L // pack) % 128):
            pack //= 2
    else:
        while pack > 1 and S % pack:
            pack //= 2
    return max(1, pack)


def default_pack(meta: SceneMeta, spp: int = None) -> int:
    """Sample packing factor: 1 for primitive scenes, 8 for mesh scenes;
    PT_SPP_PACK overrides, clamped to divide spp when given."""
    pack = int(os.environ.get("PT_SPP_PACK",
                              "8" if meta.has_groups else "1"))
    if spp is not None:
        while pack > 1 and spp % pack:
            pack //= 2
    return max(1, pack)


_ORDERS = ("linear", "block", "subblock", "rowblock")


def _grid(n: int) -> Tuple[int, int]:
    """(gx, gy) with gx * gy = n and gx the largest divisor <= sqrt(n)."""
    gx = int(math.isqrt(n))
    while n % gx:
        gx -= 1
    return gx, n // gx


def _block_slot_xy(order: str, i, S: int, L: int, bw: int, bh: int):
    """The (x, y) inside its bw x bh block of slot i of an (S, L) tile
    (pallas_kernel.tile_pixel_layout :548-584): scanline in the block for
    "block"; under "rowblock" tile row s is one compact (bw/gx) x (bh/gy)
    rect of a gx x gy grid; under "subblock" the 128-lane chunk j of the
    tile (its S rows) is one compact sub-block of a grid over the L/128
    chunks. A tile of one row, or of one chunk, keeps the block order."""
    nc = L // 128 if (L % 128 == 0 and L > 128) else 1
    s, l = i // L, i % L
    if order == "rowblock" and S > 1:
        gx, gy = _grid(S)
        rw, rh = bw // gx, bh // gy       # rw * rh == L
        return (s % gx) * rw + l % rw, (s // gx) * rh + l // rw
    if order == "subblock" and nc > 1:
        j, m = l // 128, l % 128
        p = s * 128 + m                   # [0, S*128): the sub-block
        gx, gy = _grid(nc)
        sbw = bw // gx                    # sbw * (bh / gy) == S * 128
        return (j % gx) * sbw + p % sbw, (j // gx) * (bh // gy) + p // sbw
    return i % bw, i // bw


def tile_pixel_layout(W: int, H: int, S: int, L: int,
                      shard_granule: int = 1, order: str = None,
                      spp_pack: int = 1, pack_axis: str = "row"):
    """Assign pixels to tile slots.

    Returns (px [rows, L] i32, py [rows, L] i32, pid [rows*L] i64) where
    pid maps each slot to its flat pixel index (-1 = padding slot, which
    renders a duplicate pixel and is dropped by untile_image). Orders
    "linear" (scanline) and "block" (square blocks of S*L pixels); rows
    are padded to a multiple of S*shard_granule.

    spp_pack=s > 1 packs sample replicas into each tile: one compact block
    of S*L/s pixels, repeated across s sublane-row groups
    (pack_axis="row") or across s lane-chunk groups of L/s lanes, a
    multiple of 128 (pack_axis="chunk"). Replicated slots share the pixel
    id, so untile_image sums them. "subblock" permutes a block's slots so
    that each 128-lane chunk of a tile row set is a compact sub-block, and
    "rowblock" so that each tile row is a compact sub-rectangle (the orders
    of the JAX package's sub-packet gating and MXU leaf machine); on the
    card they only number the slots, which fixes the random stream and the
    checkpoint layout."""
    if order is None:
        order = os.environ.get("PT_TILE_ORDER", "block")
    if order not in _ORDERS:
        raise ValueError(f"tile order {order!r} is not one of {_ORDERS}")
    if spp_pack > 1 and pack_axis == "chunk":
        if L % spp_pack or (L // spp_pack) % 128:
            raise ValueError(
                f"chunk pack={spp_pack} needs L={L} to split into "
                f"128-lane-aligned replica groups")
        cw = L // spp_pack
        xs, ys, pid = tile_pixel_layout(
            W, H, S, cw, shard_granule=shard_granule, order=order)
        xs = np.ascontiguousarray(np.tile(xs, (1, spp_pack)))
        ys = np.ascontiguousarray(np.tile(ys, (1, spp_pack)))
        pid = np.ascontiguousarray(
            np.tile(pid.reshape(-1, cw), (1, spp_pack))).reshape(-1)
        return xs, ys, pid
    if spp_pack > 1:
        if pack_axis != "row":
            raise ValueError(f"pack_axis {pack_axis!r} is not row or chunk")
        if S % spp_pack:
            raise ValueError(f"spp_pack={spp_pack} must divide S={S}")
        Ss = S // spp_pack
        xs, ys, pid = tile_pixel_layout(W, H, Ss, L, order=order)
        n_tiles = xs.shape[0] // Ss

        def rep(a):
            return np.ascontiguousarray(np.broadcast_to(
                a.reshape(n_tiles, 1, Ss, L),
                (n_tiles, spp_pack, Ss, L)).reshape(-1, L))

        xs = rep(xs)
        ys = rep(ys)
        pid = np.ascontiguousarray(
            np.broadcast_to(pid.reshape(n_tiles, 1, Ss * L),
                            (n_tiles, spp_pack, Ss * L))).reshape(-1)
        extra_t = (-n_tiles) % shard_granule
        if extra_t:   # pad with whole dummy tiles for even sharding
            xs = np.concatenate(
                [xs, np.full((extra_t * S, L), W - 1, np.int32)])
            ys = np.concatenate(
                [ys, np.full((extra_t * S, L), H - 1, np.int32)])
            pid = np.concatenate(
                [pid, np.full(extra_t * S * L, -1, pid.dtype)])
        return xs, ys, pid
    tile_sz = S * L
    n_pix = W * H
    if order != "linear":
        side = int(math.isqrt(tile_sz))
        while tile_sz % side:
            side -= 1
        bw, bh = tile_sz // side, side    # e.g. 4096 -> 64x64
        nbx = -(-W // bw)
        nby = -(-H // bh)
        k = np.arange(nbx * nby * tile_sz)
        b = k // tile_sz                  # block id
        i = k % tile_sz                   # slot within block
        ix, iy = _block_slot_xy(order, i, S, L, bw, bh)
        x = (b % nbx) * bw + ix
        y = (b // nbx) * bh + iy
        valid = (x < W) & (y < H)
        pid = np.where(valid, y * W + x, -1)
        xs = np.minimum(x, W - 1).astype(np.int32)
        ys = np.minimum(y, H - 1).astype(np.int32)
    else:
        pad = (-n_pix) % tile_sz
        ids = np.arange(n_pix + pad)
        pid = np.where(ids < n_pix, ids, -1)
        xs = (ids % W).astype(np.int32)
        ys = np.minimum(ids // W, H - 1).astype(np.int32)

    rows = xs.shape[0] // L
    extra = (-rows) % (S * shard_granule)
    if extra:
        xs = np.concatenate([xs, np.full(extra * L, W - 1, np.int32)])
        ys = np.concatenate([ys, np.full(extra * L, H - 1, np.int32)])
        pid = np.concatenate([pid, np.full(extra * L, -1, pid.dtype)])
        rows += extra
    return xs.reshape(rows, L), ys.reshape(rows, L), pid


def untile_image(flat: np.ndarray, pid: np.ndarray, W: int, H: int
                 ) -> np.ndarray:
    """Scatter tiled per-slot values [rows*L, C] back to [H*W, C]; padding
    slots (pid -1) are dropped, duplicate pids (sample replicas) add."""
    out = np.zeros((W * H, flat.shape[-1]), dtype=flat.dtype)
    valid = pid >= 0
    np.add.at(out, pid[valid], flat[valid])
    return out


def replica_stride(S: int, L: int, spp_pack: int, pack_axis: str) -> int:
    """The slots between a sample replica and the next in a layout of
    tile_pixel_layout: L / spp_pack on the lane chunks, (S / spp_pack) * L
    on the tile rows (L without packing). Base slot i (replica 0) is slot
    (i // g) * g * spp_pack + i % g for this stride g."""
    if spp_pack == 1:
        return L
    if pack_axis == "chunk":
        return L // spp_pack
    return (S // spp_pack) * L


def base_slot_pixels(pid: np.ndarray, S: int, L: int, spp_pack: int,
                     pack_axis: str) -> np.ndarray:
    """The pixel of each base slot of a layout of tile_pixel_layout (pid
    [rows*L], -1 padding), in base-slot order: int32 [rows*L / spp_pack].
    Each valid pixel has exactly one base slot."""
    g = replica_stride(S, L, spp_pack, pack_axis)
    return np.ascontiguousarray(
        pid.reshape(-1, spp_pack, g)[:, 0], dtype=np.int32).reshape(-1)


def build_camera_vec(cam) -> np.ndarray:
    """Build the [_CAM_COLS] float32 camera vector from the host Camera."""
    out = np.zeros((_CAM_COLS,), dtype=np.float32)
    inv = np.asarray(cam.inverse, dtype=np.float32)
    out[0:12] = inv[:3, :].reshape(12)
    out[12] = float(cam.pixel_size)
    out[13] = float(cam.half_width)
    out[14] = float(cam.half_height)
    out[15] = float(cam.aperture)
    out[16] = float(cam.focal_length)
    return out


# --- kernel PRNG (plain version) --------------------------------------------
#
# The murmur3 counter hash of pallas_kernel._prng_seed/_uniform, on int64
# tensors: torch on the CPU has no >> for uint32, so every multiply and add
# is masked back to 32 bits (the low 32 bits survive int64 wraparound).
# csrc/megakernel.cu computes the same hash in uint32.

def _prng_key(seed: int, tile):
    """Per-tile key: seed*0x9E3779B1 ^ tile*0x85EBCA77 (mod 2^32)."""
    tile = torch.as_tensor(tile, dtype=torch.int64)
    return ((((int(seed) & _M32) * 0x9E3779B1) & _M32)
            ^ ((tile * 0x85EBCA77) & _M32))


def _hash_uniform(key, elem, did: int, n: int = None, b: int = None):
    """f32 uniforms in [0,1) for int64 `key` and element index `elem`
    (broadcastable): the top 24 bits of the murmur3 finalizer over
    key ^ did*C1 + n*C2 + b*C3 + elem."""
    h = key ^ ((did * 0xC2B2AE3D) & _M32)
    if n is not None:
        h = (h + ((int(n) * 0x27D4EB2F) & _M32)) & _M32
    if b is not None:
        h = (h + ((int(b) * 0x165667B1) & _M32)) & _M32
    x = (h + elem) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * _INV24


def _uniform(key, shape, did=0, n=None, b=None):
    """One tile of uniforms for tile key `key`: the element index is
    r0*L + r1 (pallas_kernel._uniform in interpret mode)."""
    S, L = shape
    elem = torch.arange(S * L, dtype=torch.int64).reshape(S, L)
    return _hash_uniform(key, elem, did, n, b)


def _uniform_row(key, shape, did=0, n=None, b=None):
    """One shared uniform per tile row: the draw at (r0, lane 0)
    broadcast over the row (pallas_kernel._uniform_row)."""
    S, L = shape
    elem = (torch.arange(S, dtype=torch.int64) * L).reshape(S, 1)
    return _hash_uniform(key, elem, did, n, b).expand(S, L)


def _uniform_chunk(key, shape, cw, did=0, n=None, b=None):
    """One shared uniform per cw-lane chunk of the tile: the draw at
    (row 0, lane c*cw) broadcast over chunk c (pallas_kernel._uniform_chunk;
    the coherent-sampling unit of chunk-packed tiles)."""
    S, L = shape
    elem = ((torch.arange(L, dtype=torch.int64) // cw) * cw).reshape(1, L)
    return _hash_uniform(key, elem, did, n, b).expand(S, L)


def _coherent_elem(row_in_tile, lane, L: int, pack_axis: str):
    """Element index of the coherent (shared) roulette and hemisphere draws
    of each slot: lane 0 of its tile row (_uniform_row), or lane c*128 of
    row 0 for its 128-lane chunk c when the replicas run along the chunks
    (_uniform_chunk). The JAX kernel picks the chunk unit when
    pack_axis == "chunk" and L >= 128."""
    if pack_axis == "chunk" and L >= 128:
        return (lane // 128) * 128
    return row_in_tile * L


def _coherent_sampling() -> bool:
    """Row-shared roulette and hemisphere draws (PT_COHERENT=1, the
    default), as pallas_kernel._coherent_sampling."""
    return os.environ.get("PT_COHERENT", "1") != "0"


# --- ray-primitive functions (plain version) -------------------------------
#
# Same f32 formulas, in the same order, as pallas_kernel (:761-878); their
# CUDA twins are the __device__ functions of csrc/megakernel.cu.

def _mat12_point(m, x, y, z):
    return (
        m[0] * x + m[1] * y + m[2] * z + m[3],
        m[4] * x + m[5] * y + m[6] * z + m[7],
        m[8] * x + m[9] * y + m[10] * z + m[11],
    )


def _mat12_vec(m, x, y, z):
    return (
        m[0] * x + m[1] * y + m[2] * z,
        m[4] * x + m[5] * y + m[6] * z,
        m[8] * x + m[9] * y + m[10] * z,
    )


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize(x, y, z):
    # 1/sqrt with IEEE sqrt and division: what the CUDA twin computes
    inv = 1.0 / torch.sqrt(x * x + y * y + z * z)
    return x * inv, y * inv, z * inv


def _axis_slab(o, d, mn, mx, eps):
    use = torch.abs(d) >= eps
    d_safe = torch.where(use, d, 1.0)
    t1 = torch.where(use, (mn - o) / d_safe, (mn - o) * _BIG)
    t2 = torch.where(use, (mx - o) / d_safe, (mx - o) * _BIG)
    return torch.minimum(t1, t2), torch.maximum(t1, t2)


def _plane_t(oy, dy, eps):
    ok = torch.abs(dy) > eps
    t = -oy / torch.where(ok, dy, 1.0)
    return torch.where(ok & (t > eps), t, _BIG)


def _sphere_t(ox, oy, oz, dx, dy, dz, eps):
    a = dx * dx + dy * dy + dz * dz
    t_mid = -(ox * dx + oy * dy + oz * dz) / a
    mx = ox + dx * t_mid
    my = oy + dy * t_mid
    mz = oz + dz * t_mid
    perp2 = mx * mx + my * my + mz * mz
    ok = perp2 < 1.0
    dt = torch.sqrt(torch.where(ok, (1.0 - perp2) / a, 0.0))
    t1 = t_mid - dt
    t2 = t_mid + dt
    return torch.minimum(
        torch.where(ok & (t1 > eps), t1, _BIG),
        torch.where(ok & (t2 > eps), t2, _BIG),
    )


def _cylinder_t(ox, oy, oz, dx, dy, dz, min_y, max_y, eps):
    a = dx * dx + dz * dz
    ok_a = torch.abs(a) >= eps
    a_safe = torch.where(ok_a, a, 1.0)
    t_mid = -(ox * dx + oz * dz) / a_safe
    mx = ox + dx * t_mid
    mz = oz + dz * t_mid
    perp2 = mx * mx + mz * mz
    ok = ok_a & (perp2 <= 1.0)
    dt = torch.sqrt(torch.where(ok, (1.0 - perp2) / a_safe, 0.0))
    t0 = t_mid - dt
    t1 = t_mid + dt
    y0 = oy + t0 * dy
    y1 = oy + t1 * dy
    v0 = ok & (y0 > min_y) & (y0 < max_y) & (t0 > eps)
    v1 = ok & (y1 > min_y) & (y1 < max_y) & (t1 > eps)
    return torch.minimum(torch.where(v0, t0, _BIG),
                         torch.where(v1, t1, _BIG))


# the object loop's filter (csrc/megakernel.cu plane_skip, round_skip, and
# the argument that it is exact there): 1 - 2^-21, 2^-12, 1 + 2^-19, 2^-16
_K_SHRINK = 1.0 - 2.0 ** -21
_K_MISS = 2.0 ** -12
_K_GROW = 1.0 + 2.0 ** -19
_K_FAR = 2.0 ** -16


def _plane_skip(oy, dy, T):
    """Plain version of the kernel's plane_skip: where _plane_t(oy, dy, eps)
    is certainly not below T (T > eps), by f32 products alone."""
    lim = T * torch.abs(dy)
    same = (oy.view(torch.int32) ^ dy.view(torch.int32)) >= 0
    return same | ((torch.abs(oy) * _K_SHRINK >= lim) & (lim >= 2.0 ** -126))


def _round_skip(a, b, c, T):
    """Plain version of the kernel's round_skip: where the sphere's or the
    cylinder's test with a = |d|^2, b = o.d, c = |o|^2 (its own sums) is
    certainly not below T (T > eps)."""
    ca = c * a
    sane = (a >= 2.0 ** -40) & (ca <= 2.0 ** 100)
    miss = ca - b * b >= a + _K_MISS * ca
    y = -b - T * (a * _K_GROW)
    far = (y > 0.0) & (y * y >= a * (1.0 + _K_FAR * (1.0 + c)))
    return sane & (miss | far)


def object_skip(code: int, T, ox, oy, oz, dx, dy, dz):
    """Where the filter skips the test of an object of type `code` (PLANE,
    SPHERE or CYLINDER) for the object-space rays: its exact t
    (_primitive_t) is certainly not below the thresholds T (> eps)."""
    if code == PLANE:
        return _plane_skip(oy, dy, T)
    if code == SPHERE:
        return _round_skip(dx * dx + dy * dy + dz * dz,
                           ox * dx + oy * dy + oz * dz,
                           ox * ox + oy * oy + oz * oz, T)
    if code == CYLINDER:
        return _round_skip(dx * dx + dz * dz, ox * dx + oz * dz,
                           ox * ox + oz * oz, T)
    raise ValueError(f"no filter for object type {code}")


def _box_t(ox, oy, oz, dx, dy, dz, eps):
    x1, x2 = _axis_slab(ox, dx, -1.0, 1.0, eps)
    y1, y2 = _axis_slab(oy, dy, -1.0, 1.0, eps)
    z1, z2 = _axis_slab(oz, dz, -1.0, 1.0, eps)
    tmin = torch.maximum(torch.maximum(x1, y1), z1)
    tmax = torch.minimum(torch.minimum(x2, y2), z2)
    ok = tmin <= tmax
    return torch.minimum(
        torch.where(ok & (tmin > eps), tmin, _BIG),
        torch.where(ok & (tmax > eps), tmax, _BIG),
    )


def _schlick(cx, cy, cz, nx, ny, nz, n1, n2):
    """tracer.cl:485-505; n1/n2 are tensors (a Python scalar divided by a
    tensor would round twice, through torch's reciprocal)."""
    cos = _dot(cx, cy, cz, nx, ny, nz)
    n = n1 / n2
    sin2t = (n * n) * (1.0 - cos * cos)
    tir = (n1 > n2) & (sin2t > 1.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2t, min=0.0))
    cos_eff = torch.where(n1 > n2, cos_t, cos)
    temp = (n1 - n2) / (n1 + n2)
    r0 = temp * temp
    m = 1.0 - cos_eff
    m2 = m * m
    res = r0 + (1.0 - r0) * (m2 * m2 * m)
    return torch.where(tir, 1.0, res)


def _refract(cx, cy, cz, nx, ny, nz, n1, n2):
    cos_i = _dot(cx, cy, cz, nx, ny, nz)
    ratio = n1 / n2
    sin2t = (ratio * ratio) * (1.0 - cos_i * cos_i)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2t, min=0.0))
    k = ratio * cos_i - cos_t
    ok = sin2t <= 1.0
    return (
        torch.where(ok, nx * k - cx * ratio, 0.0),
        torch.where(ok, ny * k - cy * ratio, 0.0),
        torch.where(ok, nz * k - cz * ratio, 0.0),
    )


def _sun_constants(total_samples: int):
    """Sunflower DoF constants (pallas_kernel._make_kernel :1930-1932,
    :2049-2055): the cut-off index, the radius divisor and golden^2,
    as the f32 values the kernel compares and divides with."""
    sun_n = float(total_samples)
    sun_b = round(2.0 * math.sqrt(sun_n))
    golden2 = ((math.sqrt(5.0) + 1.0) / 2.0) ** 2
    return (sun_n - sun_b,
            math.sqrt(max(sun_n - (sun_b + 1.0) / 2.0, 1e-9)),
            golden2)


# --- UV maps and texel fetch (plain version) ------------------------------
#
# The megakernel's UV maps (pallas_kernel.py:881-965), operation for
# operation: atan2 and acos from a degree-13 odd polynomial with octant
# reduction (the TPU has neither), the cube cross with a truncating fmod
# that multiplies by 1/b. Their CUDA twins are in csrc/megakernel.cu.

def _atan_poly(z):
    """atan(z) for z in [0, 1]: odd degree-13 least-squares fit."""
    z2 = z * z
    return z * (0.99999659 + z2 * (-0.33319012 + z2 * (0.19823318
        + z2 * (-0.13294270 + z2 * (0.08076473 + z2 * (-0.03461463
        + z2 * 0.00715190))))))


def _atan2(y, x):
    """Four-quadrant atan2 by octant reduction to _atan_poly."""
    ay = torch.abs(y)
    ax = torch.abs(x)
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.where(swap, ay, ax)
    r = _atan_poly(num / torch.clamp(den, min=1e-30))
    r = torch.where(swap, math.pi / 2 - r, r)
    r = torch.where(x < 0.0, math.pi - r, r)
    return torch.where(y < 0.0, -r, r)


def _acos(x):
    """acos(x) = atan2(sqrt(1 - x^2), x) for x in [-1, 1]."""
    return _atan2(torch.sqrt(torch.clamp((1.0 - x) * (1.0 + x), min=0.0)), x)


def _spherical_uv(lx, ly, lz):
    """Unit-sphere local point -> (u, v): uv.spherical_map with the
    integrator's v flip folded in (tracer.cl:178-213)."""
    theta = _atan2(lx, lz)
    radius = torch.sqrt(lx * lx + ly * ly + lz * lz)
    phi = _acos(torch.clamp(ly / radius, -1.0, 1.0))
    raw_u = theta * float(np.float32(1.0 / (2.0 * math.pi)))
    return 1.0 - (raw_u + 0.5), phi * float(np.float32(1.0 / math.pi))


def _cfmod(a, b: float):
    """C fmod (truncated, the dividend's sign) as the JAX kernel computes
    it: a - b * trunc(a * (1/b))."""
    return a - b * torch.trunc(a * (1.0 / b))


def _cube_uv(x, y, z):
    """Cube-cross UV of a unit-cube local point (uv.cube_uv,
    tracer.cl:113-175)."""
    coord = torch.maximum(torch.maximum(torch.abs(x), torch.abs(y)),
                          torch.abs(z))
    third = 0.333333
    v_mid = 0.6666666 - (_cfmod(y + 1.0, 2.0) * 0.5) * third
    u_right = 0.5 + (_cfmod(1.0 - z, 2.0) * 0.5) * 0.25
    u_left = (_cfmod(z + 1.0, 2.0) * 0.5) * 0.25
    u_top = 0.25 + (_cfmod(x + 1.0, 2.0) * 0.5) * 0.25
    v_top = 1.0 - (_cfmod(1.0 - z, 2.0) * 0.5) * third
    v_bottom = (_cfmod(z + 1.0, 2.0) * 0.5) * third
    u_back = 0.75 + (_cfmod(1.0 - x, 2.0) * 0.5) * 0.25
    sel_right = coord == x
    sel_left = ~sel_right & (coord == -x)
    sel_top = ~sel_right & ~sel_left & (coord == y)
    sel_bottom = ~sel_right & ~sel_left & ~sel_top & (coord == -y)
    sel_front = (~sel_right & ~sel_left & ~sel_top & ~sel_bottom
                 & (coord == z))
    u = torch.where(sel_right, u_right, torch.where(
        sel_left, u_left, torch.where(
            sel_top | sel_bottom | sel_front, u_top, u_back)))
    v = torch.where(sel_top, v_top, torch.where(sel_bottom, v_bottom, v_mid))
    return u, v


def _wrap_tex(a, m):
    """Floor-mod wrap of a float-held integer coordinate to [0, m)."""
    return a - m * torch.floor(a / m)


# the fast wrap's bounds (csrc/megakernel.cu kWrapFast, kSideFast) and the
# rounding constant 1.5 * 2^23
_WRAP_FAST = 2.0 ** 22
_SIDE_FAST = 2.0 ** 23
_ROUND_INT = 1.5 * 2.0 ** 23


def wrap_fast(a, m, im):
    """The kernel's wrap without a division (csrc/megakernel.cu wrap_fast):
    the floor-mod of integer-valued f32 a by integer-valued m, given im =
    fl(1/m), by rounding a * im to the nearest integer q (adding and taking
    off 1.5 * 2^23) and r = a - m q, plus m where negative. Exact, and
    equal to _wrap_tex, for |a| < 2^22 and m <= 2^23 (the source's comment
    says why); wrap_is_fast says where the fetches take it."""
    q = (a * im + _ROUND_INT) - _ROUND_INT
    r = a - m * q
    return torch.where(r < 0.0, r + m, r)


def wrap_is_fast(x0, y0, w, h):
    """Where the fetches wrap by wrap_fast: |x0|, |y0| < 2^22 and w, h <=
    2^23 (false for NaN and inf)."""
    return ((torch.abs(x0) < _WRAP_FAST) & (torch.abs(y0) < _WRAP_FAST)
            & (w <= _SIDE_FAST) & (h <= _SIDE_FAST))


def texel_taps(base, w, h, u, v, fast: bool = True):
    """The four texel indices of a bilinear REPEAT fetch at (u, v) for
    textures at (base, w, h) (f32 tensors broadcastable with u), each
    clamped into [base, base + w*h) as jnp.take(mode="clip") does, in the
    order (y0, x0), (y0, x1), (y1, x0), (y1, x1), and the x/y weights (tx,
    ty). csrc/megakernel.cu's texel_taps computes the same: with `fast`,
    where wrap_is_fast the columns wrap_fast(x0) and its neighbour (0 at
    w; the same for the rows), elsewhere, and without `fast`, the JAX
    kernel's _wrap_tex of x0, x0 + 1, y0 and y0 + 1."""
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    bi = base.long()
    wi = w.long()
    top_i = bi + wi * h.long() - 1
    cols = [_wrap_tex(x0, w), _wrap_tex(x0 + 1.0, w)]
    rows = [_wrap_tex(y0, h), _wrap_tex(y0 + 1.0, h)]
    if fast:
        ok = wrap_is_fast(x0, y0, w, h)
        one = torch.ones_like(w)
        for taps, a, m in ((cols, x0, w), (rows, y0, h)):
            c0 = wrap_fast(a, m, one / m)
            c1 = torch.where(c0 + 1.0 == m, 0.0, c0 + 1.0)
            taps[0] = torch.where(ok, c0, taps[0])
            taps[1] = torch.where(ok, c1, taps[1])
    cols = [c.long() for c in cols]
    rows = [r.long() for r in rows]
    idx = [torch.minimum(torch.maximum(bi + yi * wi + xi, bi), top_i)
           for yi in rows for xi in cols]
    return idx, tx, ty


def _blend(c, tx, ty):
    """The x-first bilinear blend of the four taps' channel lists."""
    out = []
    for k in range(3):
        top = c[0][k] * (1.0 - tx) + c[1][k] * tx
        bot = c[2][k] * (1.0 - tx) + c[3][k] * tx
        out.append(top * (1.0 - ty) + bot * ty)
    return tuple(out)


def sample_pool(pool, base, w, h, u, v, fast: bool = True):
    """Bilinear REPEAT sample of the rgb8 texel pool (int32 [T]) at (u, v)
    for textures at (base, w, h) (f32 tensors broadcastable with u): the
    four taps of texel_taps (with `fast`, the kernels' wrap; without, the
    JAX kernel's alone: the same taps), decoded as q * f32(1/255), blended
    in f32 in the JAX order (x first). Semantics of tracer.cl:829
    (normalized coords, REPEAT, LINEAR). Returns (r, g, b)."""
    idx, tx, ty = texel_taps(base, w, h, u, v, fast)
    c = [decode_rgb8(pool[i]) for i in idx]
    return _blend(c, tx, ty)


def sample_texels(texels, base, w, h, u, v):
    """sample_pool on f32 texels ([T, 3], or [T, 4] whose last column is
    not read): the same taps and blend, the texel loaded instead of
    decoded. With texels = scene.pack.texel_params (the pool decoded) it
    returns sample_pool's values bit for bit. Returns (r, g, b)."""
    idx, tx, ty = texel_taps(base, w, h, u, v)
    c = [[texels[i, k] for k in range(3)] for i in idx]
    return _blend(c, tx, ty)


# --- BVH walk (plain version) ----------------------------------------------
#
# The per-ray counterpart of pallas_kernel._packet_traverse, _leaf_tests and
# _group_octant_base, with every f32 operation in their order. The CUDA
# kernel walks each ray in the same order, so the two agree bit for bit.

# (ray, slot) pairs of one batched leaf test: bounds the [rays, leaf, 12]
# gather to 96 MB however many rays reach a leaf at once
_LEAF_PAIRS = 1 << 21


def _inv_safe(td, eps):
    """1/d for the slab tests, hoisted out of the walk; near-zero
    components take the BIG branch (pallas_kernel.py:1428-1434)."""
    ok = torch.abs(td) >= eps
    return torch.where(ok, 1.0 / torch.where(ok, td, 1.0), _BIG)


def leaf_tests(tri, start, leaf_size, eps, ox, oy, oz, dx, dy, dz,
               cut=None):
    """Dual-basis tests of the leaf_size slots from `start` for each ray
    (pallas_kernel._leaf_tests), on the test records `tri` [Ns, 12]
    (build_mesh_tables). Returns (tw, slot, u, v): the closest
    valid t per ray (_BIG when none), its slot (the lowest on ties, as
    the JAX min-tree keeps) and the barycentrics there. With `cut` (per
    ray, at most the ray's best t and t_max: the shadow query's any-hit
    walk), a fifth tensor holds the slots the kernel's leaf_simt<true>
    tests: up to the first valid t below the cut, where it returns."""
    ar = torch.arange(leaf_size, device=start.device)
    slots = start[:, None] + ar                      # [B, K]
    rows = tri[slots]                                # [B, K, 12]

    def c(i):
        return rows[..., i]

    ox, oy, oz, dx, dy, dz = (a[:, None] for a in (ox, oy, oz, dx, dy, dz))
    pxx = ox - c(0)
    pyy = oy - c(1)
    pzz = oz - c(2)
    den = dx * c(3) + dy * c(4) + dz * c(5)
    num_t = -(pxx * c(3) + pyy * c(4) + pzz * c(5))
    den_ok = torch.abs(den) >= eps
    f = 1.0 / torch.where(den_ok, den, 1.0)
    t = num_t * f
    hx = pxx + t * dx
    hy = pyy + t * dy
    hz = pzz + t * dz
    u = hx * c(6) + hy * c(7) + hz * c(8)
    v = hx * c(9) + hy * c(10) + hz * c(11)
    valid = (den_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > eps))
    tv = torch.where(valid, t, _BIG)
    tw = tv.min(dim=1).values
    k = torch.where(tv == tw[:, None], ar, leaf_size).min(dim=1).values
    pick = k[:, None]
    out = (tw, start + k, u.gather(1, pick).squeeze(1),
           v.gather(1, pick).squeeze(1))
    if cut is None:
        return out
    first = torch.where(tv < cut[:, None], ar, leaf_size).min(dim=1).values
    return out + (torch.clamp(first + 1, max=leaf_size),)


def leaf_tests_mma(frag, start, leaf_size, eps, ox, oy, oz, dx, dy, dz,
                    pairs: bool = False):
    """The tensor-core leaf test of the kernel (leaf_mma), plain: the six
    plane dots of each of the leaf's K triangles (its plane tiles `frag`,
    mxu_view, decoded by mxu_groups) against q = [o, 1, d, 0], products and sums in f64 and each
    dot rounded once to f32 (the DMMA's exact products); then, in f32, t =
    num_t * (1 / den), u = ou + t du, v = ov + t dv (the JAX package's
    _packet_traverse_mxu :1799-1803) and leaf_tests' validity and winner
    (the lowest slot on ties). Returns (tw, slot, u, v) as leaf_tests;
    with `pairs`, every ray x triangle t instead ([B, K], _BIG where the
    pair does not hit)."""
    K = leaf_size
    blk = mxu_groups(frag[start // K], K).double()    # [B, 6, K, 4]
    o = torch.stack([ox, oy, oz, torch.ones_like(ox)], 1).double()
    d = torch.stack([dx, dy, dz, torch.zeros_like(dx)], 1).double()

    def dot(g, q):
        c = blk[:, g]
        return (((c[..., 0] * q[:, None, 0] + c[..., 1] * q[:, None, 1])
                 + c[..., 2] * q[:, None, 2]) + c[..., 3] * q[:, None, 3]
                ).float()

    den, num_t, ou, du, ov, dv = (dot(g, d if h else o)
                                  for g, h in enumerate(_MXU_D_HALF))
    den_ok = torch.abs(den) >= eps
    t = num_t * (1.0 / torch.where(den_ok, den, 1.0))
    u = ou + t * du
    v = ov + t * dv
    valid = den_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    tv = torch.where(valid, t, _BIG)
    if pairs:
        return tv
    tw = tv.min(dim=1).values
    ar = torch.arange(K, device=start.device)
    k = torch.where(tv == tw[:, None], ar, K).min(dim=1).values
    pick = k[:, None]
    return (tw, start + k, u.gather(1, pick).squeeze(1),
            v.gather(1, pick).squeeze(1))


def _slab_hit(nd, ray, bt, eps):
    """The slab test of each ray against its node row nd (the kernel's,
    pallas_kernel.py:1460-1473) with its running best t."""
    ox, oy, oz, _, _, _, ivx, ivy, ivz = ray
    ax1 = (nd[:, 0] - ox) * ivx
    ax2 = (nd[:, 4] - ox) * ivx
    ay1 = (nd[:, 1] - oy) * ivy
    ay2 = (nd[:, 5] - oy) * ivy
    az1 = (nd[:, 2] - oz) * ivz
    az2 = (nd[:, 6] - oz) * ivz
    tmin = torch.maximum(
        torch.maximum(torch.minimum(ax1, ax2), torch.minimum(ay1, ay2)),
        torch.minimum(az1, az2))
    tmax = torch.minimum(
        torch.minimum(torch.maximum(ax1, ax2), torch.maximum(ay1, ay2)),
        torch.maximum(az1, az2))
    return (tmin <= tmax) & (tmax > eps) & (tmin < bt)


def _octant(dx, dy, dz):
    return (dx < 0.0).long() + 2 * (dy < 0.0).long() + 4 * (dz < 0.0).long()


def _group_octant(group, dx, dy, dz):
    """Each ray's octant copy under its group's majority: per axis,
    strictly more than half of the group's (active) rays negative
    (pallas_kernel._group_octant_base :1238-1245; the kernel's votes)."""
    _, inv = torch.unique(group, return_inverse=True)
    n = torch.bincount(inv)

    def bit(neg):
        return 2 * torch.bincount(inv, weights=neg.double(),
                                  minlength=n.numel()) > n

    return (bit(dx < 0.0).long() + 2 * bit(dy < 0.0).long()
            + 4 * bit(dz < 0.0).long())[inv]


def traverse_reference(node_table, tri_table, shade_table, leaf_size: int,
                       eps: float, t_max: float, root: int, end: int,
                       tox, toy, toz, tdx, tdy, tdz, active, bt0,
                       n_nodes: int = 0,
                       return_slot: bool = False, counts: dict = None,
                       walk: Walk = Walk(), groups=(None, None),
                       mxu=None, cut=None):
    """Plain skip-link BVH walk of one group's nodes [root, end).

    Counterpart of pallas_kernel._packet_traverse, on the tables of
    build_mesh_tables (nodes, triangle test and shading records).
    Per-thread walk (groups (None, None)): each active ray carries its own
    node pointer: the slab test against its running best t (`tmin < bt`)
    sends it to idx + 1 on a hit and to the node's exit otherwise; at a
    hit leaf the leaf_size slots are tested (leaf_tests) and the winner is
    merged when `tw < bt & tw < t_max`. With n_nodes > 0 the table holds
    octant copies and each ray walks copy 1 + octant of its own
    direction, octant = (tdx<0) + 2(tdy<0) + 4(tdz<0)
    (_group_octant_base); with 0 it walks copy 0. Rays still walking are
    compacted every step.

    groups = (octant group, packet), int64 ids per ray (walk_groups): a
    ray walks the copy of its octant group's majority among the active
    rays, and the rays of a packet share one node pointer, which steps to
    idx + 1 when any of them hits the node; a ray tests a leaf only where
    its own slab test hits it (the kernel's warp-packet walk). A packet
    lies inside one octant group. walk.leaf "mma" tests the leaves by
    leaf_tests_mma on `mxu` (mxu_view), "none" not at all.

    Returns (t, nx, ny, nz, cr, cg, cb) shaped like tox: t starts at bt0
    and keeps it where no triangle won; the interpolated smooth normal
    n1 + u*d21 + v*d31 and the triangle color are 0 there. With
    return_slot, an eighth int64 tensor holds the winning triangle slot
    (-1 where no triangle won). `counts`, when given, gains the node
    visits ("node_visits") and the leaf slots tested ("leaf_slots"); a
    packet walk counts what its warp issues, 32 lanes a node and 32 x
    leaf_size a leaf, whatever its lanes' masks.

    cut (per ray, shaped like tox; per-thread walk only): the shadow
    query's any-hit walk (csrc/megakernel.cu walk_group<kLeaf, true>): a
    ray stops walking once its best t drops below its cut (cut <= bt0),
    and its leaf slots count up to the slot where it stopped."""
    if cut is not None and groups[1] is not None:
        raise ValueError("the any-hit walk is the per-thread walk's")
    shape = tox.shape
    dev = tox.device
    bt = bt0.reshape(-1).clone()
    win = torch.full(bt.shape, -1, dtype=torch.int64, device=dev)
    wu = torch.zeros_like(bt)
    wv = torch.zeros_like(bt)
    rid = torch.nonzero(active.reshape(-1)).squeeze(1)
    cut = None if cut is None else cut.reshape(-1)
    ray = [a.reshape(-1)[rid] for a in (tox, toy, toz, tdx, tdy, tdz)]
    ray += [_inv_safe(d, eps) for d in ray[3:]]
    idx = torch.full_like(rid, root)
    octant_group, packet = (None if g is None else g.reshape(-1)[rid]
                            for g in groups)
    if n_nodes:
        octant = (_octant(*ray[3:6]) if octant_group is None
                  else _group_octant(octant_group, *ray[3:6]))
        idx = idx + (1 + octant) * n_nodes
    stop = idx + (end - root)
    chunk = max(1, _LEAF_PAIRS // leaf_size)
    if walk.leaf == "mma":
        def leaf_fn(start, *r):
            return leaf_tests_mma(mxu, start, leaf_size, eps, *r)
    else:
        def leaf_fn(start, *r, **kw):
            return leaf_tests(tri_table, start, leaf_size, eps, *r, **kw)

    def leaves(at_leaf, nd_leaf):
        # the leaf tests of rays rid[at_leaf] at their nodes nd_leaf, the
        # winners merged
        if walk.leaf == "none":
            return 0
        tested = 0
        for i in range(0, at_leaf.numel(), chunk):
            li = at_leaf[i:i + chunk]
            r = rid[li]
            res = leaf_fn(nd_leaf[i:i + chunk, 3].long(),
                          *(a[li] for a in ray[:6]),
                          **({} if cut is None else {"cut": cut[r]}))
            tw, slot, u, v = res[:4]
            tested += (li.numel() * leaf_size if cut is None
                       else int(res[4].sum()))
            won = (tw < bt[r]) & (tw < t_max)
            r = r[won]
            bt[r] = tw[won]
            win[r] = slot[won]
            wu[r] = u[won]
            wv[r] = v[won]
        return tested

    if packet is not None:
        # one node pointer per packet: pidx[p], rays -> packet p = pinv
        _, pinv = torch.unique(packet, return_inverse=True)
        n_p = int(pinv.max()) + 1 if pinv.numel() else 0
        pidx = torch.zeros(n_p, dtype=idx.dtype, device=dev).scatter_(
            0, pinv, idx)
        pstop = pidx + (end - root)
        if not torch.equal(pidx[pinv], idx):
            raise ValueError("a packet spans two octant groups")
        while n_p:
            nd_p = node_table[pidx]
            nd = nd_p[pinv]
            hit = _slab_hit(nd, ray, bt[rid], eps)
            anyp = torch.zeros(n_p, dtype=torch.long, device=dev).index_add_(
                0, pinv, hit.long()) > 0
            leafp = anyp & (nd_p[:, 3] >= 0.0)
            at_leaf = torch.nonzero(hit & leafp[pinv]).squeeze(1)
            if counts is not None:
                counts["node_visits"] += _WARP * n_p
                if walk.leaf != "none":
                    counts["leaf_slots"] += (_WARP * leaf_size
                                             * int(leafp.sum()))
            leaves(at_leaf, nd[at_leaf])
            pidx = torch.where(anyp, pidx + 1, nd_p[:, 7].long())
            keep_p = pidx < pstop
            if not bool(keep_p.all()):
                remap = torch.cumsum(keep_p.long(), 0) - 1
                keep = torch.nonzero(keep_p[pinv]).squeeze(1)
                rid, pinv = rid[keep], remap[pinv[keep]]
                ray = [a[keep] for a in ray]
                pidx, pstop = pidx[keep_p], pstop[keep_p]
                n_p = pidx.numel()
        rid = rid[:0]
    while rid.numel():
        nd = node_table[idx]
        hit = _slab_hit(nd, ray, bt[rid], eps)
        at_leaf = torch.nonzero(hit & (nd[:, 3] >= 0.0)).squeeze(1)
        tested = leaves(at_leaf, nd[at_leaf])
        if counts is not None:
            counts["node_visits"] += rid.numel()
            counts["leaf_slots"] += tested
        idx = torch.where(hit, idx + 1, nd[:, 7].long())
        walking = idx < stop
        if cut is not None:
            walking &= ~(bt[rid] < cut[rid])    # the any-hit exit
        keep = torch.nonzero(walking).squeeze(1)
        if keep.numel() < rid.numel():
            rid, idx, stop = rid[keep], idx[keep], stop[keep]
            ray = [a[keep] for a in ray]

    out = [bt] + [torch.zeros_like(bt) for _ in range(6)]
    r = torch.nonzero(win >= 0).squeeze(1)
    if r.numel():
        row = shade_table[win[r]]
        u, v = wu[r], wv[r]
        for k in range(3):
            # smooth normal n2*u + n3*v + n1*(1-u-v) (tracer.cl:669)
            out[1 + k][r] = row[:, k] + row[:, 3 + k] * u + row[:, 6 + k] * v
            out[4 + k][r] = row[:, 9 + k]
    if return_slot:
        out.append(win)
    return tuple(o.reshape(shape) for o in out)


def nee_lights(meta: SceneMeta, cfg: RenderConfig) -> Tuple[int, ...]:
    """The lights the shadow rays aim at: meta.light_indices under cfg.nee,
    else none. A scene without a light renders as without NEE, as in the
    JAX kernel (pallas_kernel.py:2430)."""
    return tuple(meta.light_indices) if cfg.nee else ()


def _primitive_t(code: int, m, eps: float, tox, toy, toz, tdx, tdy, tdz):
    """t of a non-GROUP object of type `code` (row m) for the object-space
    rays."""
    if code == PLANE:
        return _plane_t(toy, tdy, eps)
    if code == SPHERE:
        return _sphere_t(tox, toy, toz, tdx, tdy, tdz, eps)
    if code == CYLINDER:
        return _cylinder_t(tox, toy, toz, tdx, tdy, tdz, m[32], m[33], eps)
    return _box_t(tox, toy, toz, tdx, tdy, tdz, eps)


def _group_pretest(m, eps: float, tox, toy, toz, tdx, tdy, tdz, bt):
    """A GROUP's object-space bbox pretest (row m) against the running best
    t: the rays that walk it."""
    x1, x2 = _axis_slab(tox, tdx, m[34], m[37], eps)
    y1, y2 = _axis_slab(toy, tdy, m[35], m[38], eps)
    z1, z2 = _axis_slab(toz, tdz, m[36], m[39], eps)
    gtmin = torch.maximum(torch.maximum(x1, y1), z1)
    gtmax = torch.minimum(torch.minimum(x2, y2), z2)
    return (gtmin <= gtmax) & (gtmax > eps) & (gtmin < bt)


def _object_y(m, x, y, z, dx, dy, dz):
    """Row 1 of object row m's inverse applied to the point and the vector
    (the plane test's toy, tdy): _mat12_point's and _mat12_vec's own
    operations for y."""
    return (m[4] * x + m[5] * y + m[6] * z + m[7],
            m[4] * dx + m[5] * dy + m[6] * dz)


def _object_t(code: int, m, eps: float, ox, oy, oz, dx, dy, dz):
    """t of a non-GROUP object of type `code` (row m) for the world rays,
    transforming only what its test reads: a plane its y row, the others
    the whole ray."""
    if code == PLANE:
        return _plane_t(*_object_y(m, ox, oy, oz, dx, dy, dz), eps)
    return _primitive_t(code, m, eps, *_mat12_point(m, ox, oy, oz),
                        *_mat12_vec(m, dx, dy, dz))


def _nearest_hit(obj, meta: SceneMeta, node_table, tri_table, shade_table,
                 eps: float, t_max: float, ox, oy, oz, dx, dy, dz, active,
                 w0: int, counts: dict = None, walk: Walk = Walk(),
                 groups=(None, None)):
    """Plain whole-scene nearest hit (the TPU kernels' unrolled object loop;
    csrc/megakernel.cu's nearest_hit): each object's test in table order,
    transforming only what it reads (_object_t; a GROUP the whole ray for
    its object-space box pretest, gated on `active`, and then its walk,
    traverse_reference under `walk` and `groups`, per ray of ox's flat
    order), the winner replaced on a strictly smaller t; then the winner's
    object-space ray, by the same operations as its test's transform.
    `obj` is the object table as nested lists. Returns (t, w, local ray
    (lox, loy, loz, ldx, ldy, ldz), on_tri, tri_slot, tri_nrm, tri_col):
    t is _BIG and w is w0 where nothing is hit, the local ray the world
    ray there; tri_slot is -1 and the smooth normal and color are 0 unless
    a triangle won."""
    group_bvh = {g: (r, e) for g, r, e in meta.group_bvh}
    oct_nodes = meta.n_nodes if meta.octant_orders else 0
    mxu = (mxu_view(tri_table, meta)
           if meta.has_groups and walk.leaf == "mma" else None)
    best_t = torch.full_like(ox, _BIG)
    w = torch.full(ox.shape, w0, dtype=torch.int64, device=ox.device)
    on_tri = torch.zeros_like(ox, dtype=torch.bool)
    walked = torch.zeros_like(on_tri)
    tri_slot = torch.full_like(w, -1)
    tri_nrm = [torch.zeros_like(ox) for _ in range(3)]
    tri_col = [torch.zeros_like(ox) for _ in range(3)]
    for j, code in enumerate(meta.obj_types):
        m = obj[j]
        g_tri = None
        if code != GROUP:
            t_j = _object_t(code, m, eps, ox, oy, oz, dx, dy, dz)
        else:
            # GROUP: object-space bbox pretest, then the walk
            loc = (*_mat12_point(m, ox, oy, oz), *_mat12_vec(m, dx, dy, dz))
            pre = active & _group_pretest(m, eps, *loc, best_t)
            walked = walked | pre
            root, end = group_bvh[j]
            t_j, *g_tri, g_slot = traverse_reference(
                node_table, tri_table, shade_table, meta.leaf_size, eps,
                t_max, root, end, *loc, pre, best_t, n_nodes=oct_nodes,
                return_slot=True, counts=counts, walk=walk, groups=groups,
                mxu=mxu)
        closer = t_j < best_t
        best_t = torch.where(closer, t_j, best_t)
        w = torch.where(closer, j, w)
        on_tri = torch.where(closer, g_tri is not None, on_tri)
        if g_tri is not None:
            tri_slot = torch.where(closer, g_slot, tri_slot)
            tri_nrm = [torch.where(closer, a, b)
                       for a, b in zip(g_tri[:3], tri_nrm)]
            tri_col = [torch.where(closer, a, b)
                       for a, b in zip(g_tri[3:], tri_col)]
    if counts is not None and "walk_warps" in counts:
        # the rays that walk a group, and the warps (32 rays in flat order)
        # in which some ray does
        flat = walked.reshape(-1)
        pad = torch.zeros((-flat.numel()) % 32, dtype=torch.bool,
                          device=flat.device)
        warps = torch.cat([flat, pad]).reshape(-1, 32)
        counts["walk_rays"] += int(flat.sum())
        counts["walk_warps"] += int(warps.any(dim=1).sum())
        counts["warps"] += warps.shape[0]
    # the winner's object-space ray: its row's f32 values, by tensor
    won = best_t < _BIG
    rows = torch.tensor(obj, dtype=torch.float32, device=ox.device)[
        torch.where(won, w, 0)].unbind(-1)
    loc = [torch.where(won, a, b) for a, b in zip(
        (*_mat12_point(rows, ox, oy, oz), *_mat12_vec(rows, dx, dy, dz)),
        (ox, oy, oz, dx, dy, dz))]
    return best_t, w, loc, on_tri, tri_slot, tri_nrm, tri_col


def _light_visible(obj, meta: SceneMeta, node_table, tri_table, shade_table,
                   eps: float, t_max: float, ox, oy, oz, dx, dy, dz, active,
                   l: int, counts: dict = None, walk: Walk = Walk()):
    """Plain version of csrc/megakernel.cu's light_visible, the shadow
    query of the per-thread walk: whether light `l` is the nearest hit of
    each `active` ray with eps < t < t_max (_nearest_hit's rule), and the
    light's t there. Light l wins exactly when eps < t_l < t_max, no object
    j < l has t_j <= t_l and no object j > l has t_j < t_l, with every t_j
    _nearest_hit's value; so the answer is _nearest_hit's, bit for bit. It
    takes the kernel's exits, vectorised by masks: a primitive light is
    tested first and the rays that miss it stop; then the other objects
    in table order for the rays still undecided, each stopping at its first
    occluder (t_j < cut: the float after t_l before l, t_l after it). A
    GROUP pretests and walks from the running minimum of the objects before
    it (t_l after l), with the any-hit exit below the cut
    (traverse_reference's `cut`); a GROUP light is walked in its place.
    The render decides by _nearest_hit, as the JAX kernel does; this serves
    the counts and the equivalence test. Returns (visible, t_l), t_l
    meaningful where visible. `counts`, when given, gains the rays that
    miss the light ("shadow_light_missed") and stop at an occluder
    ("shadow_occluded"), the object tests by type ("query_plane",
    "query_sphere", "query_cylinder", "query_box", "query_group": a GROUP's
    pretest) and the walks' nodes and leaf slots ("query_nodes",
    "query_slots")."""
    group_bvh = {g: (r, e) for g, r, e in meta.group_bvh}
    oct_nodes = meta.n_nodes if meta.octant_orders else 0
    big = torch.full_like(ox, _BIG)

    def test(j, live, bt, cut):
        m, code = obj[j], meta.obj_types[j]
        if counts is not None:
            counts[f"query_{TYPE_NAMES[code]}"] += int(live.sum())
        if code != GROUP:
            return _object_t(code, m, eps, ox, oy, oz, dx, dy, dz)
        loc = (*_mat12_point(m, ox, oy, oz), *_mat12_vec(m, dx, dy, dz))
        pre = live & _group_pretest(m, eps, *loc, bt)
        walked = {"node_visits": 0, "leaf_slots": 0}
        t = traverse_reference(
            node_table, tri_table, shade_table, meta.leaf_size, eps, t_max,
            *group_bvh[j], *loc, pre, bt, n_nodes=oct_nodes, counts=walked,
            walk=walk, cut=cut)[0]
        if counts is not None:
            counts["query_nodes"] += walked["node_visits"]
            counts["query_slots"] += walked["leaf_slots"]
        return torch.where(pre, t, big)

    live = active.clone()
    missed = torch.zeros_like(live)
    occluded = torch.zeros_like(live)
    group_light = meta.obj_types[l] == GROUP
    t_l, cut = big, torch.full_like(ox, -_BIG)
    if not group_light:
        t_l = test(l, live, big, cut)
        hit = (t_l > eps) & (t_l < t_max) & (t_l < _BIG)
        missed = live & ~hit
        live = live & hit
        cut = torch.nextafter(t_l, big)     # t_j <= t_l exactly when < cut
    bt = big                                # the running minimum before l
    for j in range(len(meta.obj_types)):
        if j == l:
            if group_light:
                t = test(j, live, bt, cut)
                ok = (t < bt) & (t > eps) & (t < t_max)
                missed = live & ~ok
                live = live & ok
                t_l = t
            bt = cut = t_l
            continue
        t = test(j, live, bt, cut)
        occ = live & (t < cut)
        occluded |= occ
        live = live & ~occ
        bt = torch.where(t < bt, t, bt)
    if counts is not None:
        counts["shadow_light_missed"] += int(missed.sum())
        counts["shadow_occluded"] += int(occluded.sum())
    return live, t_l


def _mxu_rows(meta: SceneMeta) -> int:
    """Rows of the triangle test table that hold the MXU fragments."""
    K = meta.leaf_size
    n = (meta.n_tri_slots // K) * mxu_tiles(K) * 32
    return -(-n // _TRI_COLS)


def mxu_view(tri_table, meta: SceneMeta):
    """The MXU plane tiles inside a triangle test table built for MXU
    leaves, in mxu_fragments' layout: [n_leaves, mxu_tiles(K), 32]."""
    K = meta.leaf_size
    nl = meta.n_tri_slots // K
    off = meta.n_tri_slots * _TRI_COLS
    n = nl * mxu_tiles(K) * 32
    return tri_table.reshape(-1)[off:off + n].reshape(nl, mxu_tiles(K), 32)


def _table_shapes(meta: SceneMeta, walk: Walk):
    """The shapes of the object, node, triangle test and shading tables of
    a scene (build_scene_table, build_mesh_tables), the test table's for
    `walk` (scene_walk: MXU leaves read fragments after its rows)."""
    n_nodes = meta.n_nodes * (9 if meta.octant_orders else 1)
    rows_t = meta.n_tri_slots
    if meta.has_groups and walk.leaf == "mma":
        rows_t += _mxu_rows(meta)
    return ((len(meta.obj_types), _OBJ_COLS), (max(1, n_nodes), _NODE_COLS),
            (max(1, rows_t) if meta.has_groups else 1, _TRI_COLS),
            (max(1, meta.n_tri_slots) if meta.has_groups else 1,
             _SHADE_COLS))


def _check_aligned(**tables) -> None:
    """The kernel reads the mesh tables as float4: raise unless each
    tensor's data starts on a 16-byte boundary."""
    for name, t in tables.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the kernel's float4 loads)")


def _check_args(seed, cam_vec, obj_table, node_table, tri_table,
                shade_table, px, py, meta, cfg, spp, tile, spp_pack,
                pack_axis, tex_pool=None, tex_table=None, tex_texels=None,
                walk: Walk = Walk()):
    """Validate what trace_tiles is handed for a launch on `walk`; raise on
    anything the kernel does not take. Returns the (seed, sample_base)
    ints."""
    if cfg.nee and tex_texels is not None:
        # the f32-texel forward serves the differentiable render, which
        # refuses NEE as the JAX package's does
        raise NotImplementedError(
            "NEE with f32 texels (tex_texels): the differentiable "
            "megakernel does not replay NEE shadow draws; render with "
            "tex_pool")
    if walk.leaf == "mma" and tex_texels is not None:
        # nor MXU leaves, as the JAX package's refuses them
        # (pallas_grad.py:1151)
        raise NotImplementedError(
            "f32 texels (tex_texels) under PT_TRAVERSAL=mxu: the "
            "differentiable megakernel replay is classic-traversal only; "
            "render with tex_pool")
    bad = [t for t in meta.obj_types
           if t not in (PLANE, SPHERE, CYLINDER, BOX, GROUP)]
    if bad:
        raise ValueError(f"object types {bad} are not primitives or groups")
    if set(meta.group_indices) != {j for j, t in enumerate(meta.obj_types)
                                   if t == GROUP}:
        raise ValueError("group_indices do not match the GROUP objects")
    if spp < 1:
        raise ValueError(f"spp={spp} must be >= 1")
    S, L = tile
    if spp % spp_pack:
        raise ValueError(f"spp_pack={spp_pack} must divide spp={spp}")
    if pack_axis == "chunk":
        if L % spp_pack or (L // spp_pack) % 128:
            raise ValueError(
                f"chunk pack={spp_pack} needs L={L} to split into "
                f"128-lane-aligned replica groups")
    elif pack_axis != "row":
        raise ValueError(f"pack_axis {pack_axis!r} is not row or chunk")
    elif S % spp_pack:
        raise ValueError(
            f"spp_pack={spp_pack} must divide the sublane count S={S}")
    if isinstance(seed, torch.Tensor):
        seed = seed.tolist()
    seed = [int(v) for v in seed]
    if len(seed) != 2:
        raise ValueError("seed must be (prng seed, global sample base)")
    dev = px.device
    obj_shape, node_shape, tri_shape, shade_shape = _table_shapes(meta, walk)
    want = (("cam_vec", cam_vec, torch.float32, (_CAM_COLS,)),
            ("obj_table", obj_table, torch.float32, obj_shape),
            ("node_table", node_table, torch.float32, node_shape),
            ("tri_table", tri_table, torch.float32, tri_shape),
            ("shade_table", shade_table, torch.float32, shade_shape),
            ("px", px, torch.int32, None),
            ("py", py, torch.int32, tuple(px.shape)))
    if has_textures(meta):
        if tex_table is None or (tex_pool is None) == (tex_texels is None):
            raise ValueError("a textured scene needs tex_table and either "
                             "tex_pool (texture_inputs) or tex_texels")
        want += (("tex_table", tex_table, torch.float32,
                  (len(meta.obj_types), _TEX_COLS)),)
        if tex_pool is not None:
            want += (("tex_pool", tex_pool, torch.int32,
                      (tex_pool.numel(),)),)
        else:
            n_tex = tex_texels.shape[0] if isinstance(
                tex_texels, torch.Tensor) else 0
            want += (("tex_texels", tex_texels, torch.float32, (n_tex, 3)),)
    elif (tex_pool is not None or tex_table is not None
          or tex_texels is not None):
        raise ValueError("tex_pool/tex_table/tex_texels given for a scene "
                         "without textures")
    for name, t, dtype, shape in want:
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{name} must be a tensor on {dev}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    if px.dim() != 2 or px.shape[1] != L or px.shape[0] % S:
        raise ValueError(f"px shape {tuple(px.shape)} is not whole "
                         f"({S}, {L}) tiles")
    for _, root, end in meta.group_bvh:
        if not 0 <= root < end <= meta.n_nodes:
            raise ValueError(f"group nodes [{root}, {end}) outside the "
                             f"pool of {meta.n_nodes}")
    return seed


class TapeEntry(NamedTuple):
    """One bounce of a sample's tape, per slot [T*S*L]: flags (1 = the
    bounce adds to the sum, 2 = it updates the mask, 4 = a direct light
    hit; 0 past the path's end and on refraction), the winner (object
    index, or -1 - slot for a mesh hit), cos, and the color, emission and
    mask (before this bounce's update) per channel. In a textured scene,
    uv holds the (u, v) of the winner's color fetch (0 where it has no
    color texture)."""
    flags: torch.Tensor
    who: torch.Tensor
    cos: torch.Tensor
    col: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    emi: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    mask: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    uv: Tuple[torch.Tensor, torch.Tensor] = None


def trace_tiles_reference(seed, cam_vec, obj_table, node_table, tri_table,
                          shade_table, px, py, meta: SceneMeta = None,
                          cfg: RenderConfig = None, spp: int = 1,
                          total_samples: int = 1,
                          tile: Tuple[int, int] = (64, 256),
                          spp_pack: int = 1, pack_axis: str = "row",
                          tex_pool=None, tex_table=None, sample_tape=None,
                          counts: dict = None, tex_texels=None,
                          walk: Walk = None):
    """Plain PyTorch version of the megakernel: the same arguments and
    result as trace_tiles, vectorised over all T*S*L slots, with a Python
    loop over samples and bounces that stops once every ray is dead (dead
    rays are inert, so this equals the JAX kernel's per-tile exit), the
    BVH walk (traverse_reference) for GROUP objects and the
    texel fetch (sample_pool, or sample_texels from tex_texels) for
    textured ones.
    Returns (r, g, b) float32 [T*S, L] radiance sums on px's device.

    sample_tape: the gradient's plain version (render/grad.py) passes a
    callable, called after each sample with that sample's bounce tape, a
    list of one TapeEntry per bounce reached (pallas_grad.py:755-778).
    counts: a dict that gains the work this run does, the numbers behind
    the kernel's bound: "samples" (slot samples), "bounces" (rays alive
    at a bounce's intersection), "hits" (bounces that hit something),
    "node_visits" and "leaf_slots" (the walk), "texel_fetches" (bilinear
    samples: color textures and normal maps), of the color fetches,
    "uv_sphere" and "uv_cube" (by the sphere and cube-cross UV maps), and,
    under cfg.nee, "shadow_rays" (light points sampled: a surface hit that
    neither refracts nor is a light, times the lights), "shadow_tests"
    (those facing the surface, whose ray is cast) and "shadow_lit" (those
    that reach their light and add); the shadow rays' nearest-hit walks
    add to "node_visits" and "leaf_slots" and, apart, to "shadow_nodes"
    and "shadow_slots". On the per-thread walk the cast shadow rays also
    go through _light_visible, the kernel's occlusion query, for its
    counts (its "shadow_light_missed", "shadow_occluded", "query_*"); a
    ray where it differs from the nearest-hit rule raises RuntimeError.

    A mesh scene walks as `walk` says (default: scene_walk, the knobs of
    mesh_walk), each slot in the octant group and packet of the kernel
    (walk_groups over the T*S*L slots)."""
    walk = scene_walk(meta) if walk is None else walk
    seed0, sample_base = _check_args(
        seed, cam_vec, obj_table, node_table, tri_table, shade_table, px, py,
        meta, cfg, spp, tile, spp_pack, pack_axis, tex_pool, tex_table,
        tex_texels, walk)
    if counts is not None:
        for k in ("samples", "bounces", "hits", "node_visits", "leaf_slots",
                  "texel_fetches", "uv_sphere", "uv_cube", "shadow_rays",
                  "shadow_tests", "shadow_lit", "shadow_nodes",
                  "shadow_slots", *QUERY_COUNTS):
            counts.setdefault(k, 0)
    lights = nee_lights(meta, cfg)
    S, L = tile
    dev = px.device
    f32 = torch.float32
    rows = px.shape[0]
    groups = walk_groups(rows * L, walk, dev)
    idx = torch.arange(rows * L, device=dev, dtype=torch.int64)
    row = idx // L
    lane = idx % L
    key = _prng_key(seed0, row // S)
    elem = (row % S) * L + lane
    u_elem = (_coherent_elem(row % S, lane, L, pack_axis)
              if _coherent_sampling() else elem)
    # sample replica of each slot (tile_pixel_layout's packing): the
    # sunflower DoF index is wave * spp_pack + replica + sample base
    if pack_axis == "chunk":
        rep = lane // (L // spp_pack)
    else:
        rep = (row % S) // (S // spp_pack)
    fx = px.reshape(-1).to(f32)
    fy = py.reshape(-1).to(f32)

    cam = cam_vec.detach().cpu().tolist()
    obj = obj_table.detach().cpu().tolist()
    types = torch.tensor(meta.obj_types, dtype=torch.int64, device=dev)
    pixel_size, half_w, half_h, aperture, focal = cam[12:17]
    oxw, oyw, ozw = cam[3], cam[7], cam[11]
    eps, t_max = cfg.epsilon, cfg.t_max
    sun_cut, sun_den, golden2 = _sun_constants(total_samples)
    # divisors as device tensors: torch divides by a CPU scalar on the
    # card through its reciprocal, which rounds twice
    sun_den = torch.tensor(sun_den, dtype=f32, device=dev)
    golden2 = torch.tensor(golden2, dtype=f32, device=dev)
    one = torch.ones_like(fx)
    zero = torch.zeros_like(fx)
    glass = torch.full_like(fx, 1.5)
    textured = has_textures(meta)
    if tex_texels is not None:
        def fetch(*a):
            return sample_texels(tex_texels, *a)
    else:
        def fetch(*a):
            return sample_pool(tex_pool, *a)

    acc_r = torch.zeros_like(fx)
    acc_g = torch.zeros_like(fx)
    acc_b = torch.zeros_like(fx)
    for n in range(spp // spp_pack):
        # --- rayForPixel (tracer.cl:745-779) ---------------------------
        jx = _hash_uniform(key, elem, 0, n)
        jy = _hash_uniform(key, elem, 1, n)
        x_off = pixel_size * (fx + jx)
        y_off = pixel_size * (fy + jy)
        pxw, pyw, pzw = _mat12_point(cam, half_w - x_off, half_h - y_off,
                                     -1.0)
        dx, dy, dz = _normalize(pxw - oxw, pyw - oyw, pzw - ozw)
        ox = torch.full_like(fx, oxw)
        oy = torch.full_like(fx, oyw)
        oz = torch.full_like(fx, ozw)
        if aperture != 0.0:
            # DoF via sunflower(totalSamples, alpha=2, n + sample base)
            nf = (n * spp_pack + rep + sample_base).to(f32)
            r_sun = torch.where(
                nf <= sun_cut,
                torch.sqrt(torch.clamp(nf - 0.5, min=0.0)) / sun_den, 1.0)
            theta = 2.0 * math.pi * nf / golden2
            sun_x = r_sun * torch.cos(theta)
            sun_y = r_sun * torch.sin(theta)
            fpx = oxw + dx * focal
            fpy = oyw + dy * focal
            fpz = ozw + dz * focal
            ox = oxw + sun_y * aperture  # the reference swaps x/y
            oy = oyw + sun_x * aperture
            dx, dy, dz = fpx - ox, fpy - oy, fpz - oz

        mask_r, mask_g, mask_b = one, one, one
        srr = torch.zeros_like(fx)
        srg = torch.zeros_like(fx)
        srb = torch.zeros_like(fx)
        alive = torch.ones_like(fx, dtype=torch.bool)
        inside = torch.zeros_like(alive)
        n_hits = torch.zeros_like(fx, dtype=torch.int32)
        eff = torch.zeros_like(n_hits)
        tape = []
        if counts is not None:
            counts["samples"] += fx.numel()
        for b in range(cfg.max_bounces):
            n_alive = int(alive.sum())
            if not n_alive:
                break
            if counts is not None:
                counts["bounces"] += n_alive
            # ---- intersect: loop over objects ---------------------------
            (best_t, w, (l_ox, l_oy, l_oz, l_dx, l_dy, l_dz), on_tri,
             tri_slot, tri_nrm, tri_col) = _nearest_hit(
                obj, meta, node_table, tri_table, shade_table, eps, t_max,
                ox, oy, oz, dx, dy, dz, alive, 0, counts, walk, groups)
            hit_ok = best_t < t_max
            t = torch.clamp(best_t, max=t_max)
            wrow = obj_table[w]
            # a mesh hit takes the triangle's color and no emission
            # (tracer.cl:672-673, 1071-1073)
            col_r = torch.where(on_tri, tri_col[0], wrow[:, 24])
            col_g = torch.where(on_tri, tri_col[1], wrow[:, 25])
            col_b = torch.where(on_tri, tri_col[2], wrow[:, 26])
            emi_r = torch.where(on_tri, 0.0, wrow[:, 27])
            emi_g = torch.where(on_tri, 0.0, wrow[:, 28])
            emi_b = torch.where(on_tri, 0.0, wrow[:, 29])
            refr, refl = wrow[:, 30], wrow[:, 31]
            w_type = types[w]
            # ---- surface normal by type (tracer.cl:903-950) -------------
            lx = l_ox + l_dx * t
            ly = l_oy + l_dy * t
            lz = l_oz + l_dz * t
            dist = lx * lx + lz * lz
            top = (dist < 1.0) & (ly >= wrow[:, 33] - eps)
            bot = (dist < 1.0) & (ly <= wrow[:, 32] + eps)
            cyl_nx = torch.where(top | bot, 0.0, lx)
            cyl_ny = torch.where(top, 1.0, torch.where(bot, -1.0, 0.0))
            cyl_nz = torch.where(top | bot, 0.0, lz)
            ax, ay, az = torch.abs(lx), torch.abs(ly), torch.abs(lz)
            maxc = torch.maximum(torch.maximum(ax, ay), az)
            sel_x = maxc == ax
            sel_y = (~sel_x) & (maxc == ay)
            box_nx = torch.where(sel_x, lx, 0.0)
            box_ny = torch.where(sel_y, ly, 0.0)
            box_nz = torch.where(sel_x | sel_y, 0.0, lz)
            is_plane = w_type == PLANE
            is_cyl = w_type == CYLINDER
            is_box = w_type == BOX
            nlx = torch.where(on_tri, tri_nrm[0], torch.where(
                is_plane, 0.0, torch.where(
                    is_cyl, cyl_nx, torch.where(is_box, box_nx, lx))))
            nly = torch.where(on_tri, tri_nrm[1], torch.where(
                is_plane, 1.0, torch.where(
                    is_cyl, cyl_ny, torch.where(is_box, box_ny, ly))))
            nlz = torch.where(on_tri, tri_nrm[2], torch.where(
                is_plane, 0.0, torch.where(
                    is_cyl, cyl_nz, torch.where(is_box, box_nz, lz))))
            if textured:
                trow = tex_table[w]
                tex_col = (trow[:, 0] > 0.5) & ~on_tri & hit_ok & alive
                tex_nm = (trow[:, 6] > 0.5) & ~on_tri & hit_ok & alive
                if counts is not None:
                    counts["texel_fetches"] += int(tex_col.sum()
                                                   + tex_nm.sum())
                    counts["uv_sphere"] += int((tex_col
                                                & (w_type == SPHERE)).sum())
                    counts["uv_cube"] += int((tex_col & is_box).sum())
                # plane normal maps: the texel is the object-space normal,
                # normalized after the inverse-transpose below
                # (tracer.cl:907-911)
                if bool(tex_nm.any()):
                    nm = fetch(trow[:, 7], trow[:, 8], trow[:, 9],
                               torch.abs(lx) * trow[:, 10],
                               torch.abs(lz) * trow[:, 11])
                    nlx = torch.where(tex_nm, nm[0], nlx)
                    nly = torch.where(tex_nm, nm[1], nly)
                    nlz = torch.where(tex_nm, nm[2], nlz)
            invt = [wrow[:, 12 + k] for k in range(12)]
            nx, ny, nz = _normalize(*_mat12_vec(invt, nlx, nly, nlz))
            ex, ey, ez = -dx, -dy, -dz
            flip = _dot(ex, ey, ez, nx, ny, nz) < 0.0
            nx = torch.where(flip, -nx, nx)
            ny = torch.where(flip, -ny, ny)
            nz = torch.where(flip, -nz, nz)
            uv = (zero, zero) if textured else None
            if textured and bool(tex_col.any()):
                # texture color (tracer.cl:1075-1093), by the UV map of
                # the winner's type
                su, sv = _spherical_uv(lx, ly, lz)
                cu, cv = _cube_uv(lx, ly, lz)
                tu = torch.where(is_plane, lx * trow[:, 4],
                                 torch.where(w_type == SPHERE, su, cu))
                tv = torch.where(is_plane, lz * trow[:, 5],
                                 torch.where(w_type == SPHERE, sv, cv))
                tcol = fetch(trow[:, 1], trow[:, 2], trow[:, 3], tu, tv)
                uv = (torch.where(tex_col, tu, 0.0),
                      torch.where(tex_col, tv, 0.0))
                col_r = torch.where(tex_col, tcol[0], col_r)
                col_g = torch.where(tex_col, tcol[1], col_g)
                col_b = torch.where(tex_col, tcol[2], col_b)

            # ---- material roulette (tracer.cl:982-1061) -----------------
            u_refl = _hash_uniform(key, u_elem, 2, n, b)
            u_schl = _hash_uniform(key, u_elem, 3, n, b)
            u1 = _hash_uniform(key, u_elem, 4, n, b)
            u2 = _hash_uniform(key, u_elem, 5, n, b)
            wx = ox + dx * t
            wy = oy + dy * t
            wz = oz + dz * t
            do_reflect = (refl != 0.0) & (u_refl < refl)
            thin = (~do_reflect) & (refr == -1.0)
            sch_thin = _schlick(ex, ey, ez, nx, ny, nz, one, glass)
            thin_pass = thin & (sch_thin < u_schl)
            thin_reflect = thin & ~(sch_thin < u_schl)
            solid = (~do_reflect) & (~thin) & (refr != 1.0)
            outside = ~inside
            sch = torch.where(outside,
                              _schlick(ex, ey, ez, nx, ny, nz, one, refr),
                              _schlick(ex, ey, ez, nx, ny, nz, refr, one))
            do_refract = solid & (sch < u_schl)
            rf_o = _refract(ex, ey, ez, nx, ny, nz, one, refr)
            rf_i = _refract(ex, ey, ez, nx, ny, nz, refr, one)
            rfx = torch.where(outside, rf_o[0], rf_i[0])
            rfy = torch.where(outside, rf_o[1], rf_i[1])
            rfz = torch.where(outside, rf_o[2], rf_i[2])
            solid_reflect = solid & ~do_refract
            diffuse = (~do_reflect) & (~thin) & (~solid)

            # cosine-weighted hemisphere (tracer.cl:348-366)
            rand1 = 2.0 * math.pi * u1
            rand2s = torch.sqrt(u2)
            pick = torch.abs(nx) > 0.1
            axx = torch.where(pick, 0.0, one)
            axy = torch.where(pick, one, 0.0)
            ux, uy, uz = _normalize(axy * nz, -(axx * nz),
                                    axx * ny - axy * nx)
            vx2 = ny * uz - nz * uy
            vy2 = nz * ux - nx * uz
            vz2 = nx * uy - ny * ux
            cu = torch.cos(rand1) * rand2s
            cv = torch.sin(rand1) * rand2s
            cn = torch.sqrt(1.0 - u2)
            hx = ux * cu + vx2 * cv + nx * cn
            hy = uy * cu + vy2 * cv + ny * cn
            hz = uz * cu + vz2 * cv + nz * cn

            ddn = 2.0 * _dot(dx, dy, dz, nx, ny, nz)
            any_reflect = do_reflect | thin_reflect | solid_reflect

            def pick_dir(r, d, rf, h):
                return torch.where(any_reflect, r, torch.where(
                    thin_pass, d, torch.where(do_refract, rf, h)))

            ndx = pick_dir(dx - nx * ddn, dx, rfx, hx)
            ndy = pick_dir(dy - ny * ddn, dy, rfy, hy)
            ndz = pick_dir(dz - nz * ddn, dz, rfz, hz)
            cos = torch.where(diffuse, _dot(hx, hy, hz, nx, ny, nz), 1.0)
            go_under = thin_pass | do_refract
            nox = torch.where(go_under, wx - nx * eps, wx + nx * eps)
            noy = torch.where(go_under, wy - ny * eps, wy + ny * eps)
            noz = torch.where(go_under, wz - nz * eps, wz + nz * eps)

            # ---- fold resolve forward (tracer.cl:1116-1176) -------------
            rec = alive & hit_ok
            if counts is not None:
                counts["hits"] += int(rec.sum())
            no_refr = rec & ~do_refract
            is_light = emi_r > 0.0
            srr = srr + torch.where(no_refr, mask_r * emi_r, 0.0)
            srg = srg + torch.where(no_refr, mask_g * emi_g, 0.0)
            srb = srb + torch.where(no_refr, mask_b * emi_b, 0.0)
            # ---- next-event estimation (pallas_kernel.py:2421-2513): one
            # shadow ray per light toward a random point on its sphere,
            # with the pre-update mask and the post-texture color; the
            # reference's biased estimator (a BSDF hit on a light is not
            # discounted)
            nee_cond = no_refr & ~is_light
            for li, l in enumerate(lights):
                lm = obj[l]
                nu1 = _hash_uniform(key, u_elem, 6 + 2 * li, n, b)
                nu2 = _hash_uniform(key, u_elem, 7 + 2 * li, n, b)
                # randomPointOnSphere (tracer.cl:321-336) kept verbatim,
                # its latitude offset and y term included
                lat = _acos(2.0 * nu1 - 1.0) - 2.0 * math.pi
                lon = 2.0 * math.pi * nu2
                cl = torch.cos(lat)
                lpx = lm[40] + cl * torch.cos(lon) * lm[43]
                lpy = lm[41] + (torch.sin(lat) - math.pi * 0.25) * lm[43]
                lpz = lm[42] + cl * torch.sin(lon) * lm[43]
                sdx, sdy, sdz = _normalize(lpx - wx, lpy - wy, lpz - wz)
                ldn = _dot(sdx, sdy, sdz, nx, ny, nz)
                # a light behind the surface adds nothing whatever the
                # shadow ray hits: only the others walk (as in the kernel)
                cast = nee_cond & (ldn > 0.0)
                shadow = (wx + sdx * eps, wy + sdy * eps, wz + sdz * eps,
                          sdx, sdy, sdz)
                walked = None if counts is None else {"node_visits": 0,
                                                      "leaf_slots": 0}
                s_t, s_w, *_ = _nearest_hit(
                    obj, meta, node_table, tri_table, shade_table, eps,
                    t_max, *shadow, cast, -1, walked, walk, groups)
                visible = cast & (s_w == l) & (s_t > eps) & (s_t < t_max)
                if counts is not None:
                    counts["node_visits"] += walked["node_visits"]
                    counts["leaf_slots"] += walked["leaf_slots"]
                    counts["shadow_nodes"] += walked["node_visits"]
                    counts["shadow_slots"] += walked["leaf_slots"]
                    if walk.walk == "thread":
                        q_vis, q_t = _light_visible(
                            obj, meta, node_table, tri_table, shade_table,
                            eps, t_max, *shadow, cast, l, counts, walk)
                        if not (torch.equal(q_vis, visible) and torch.equal(
                                q_t[visible], s_t[visible])):
                            raise RuntimeError(
                                "the shadow query differs from the "
                                f"nearest-hit rule for light {l}")
                atten = 1.0 - s_t / torch.sqrt(s_t * s_t + lm[44] * lm[44])
                w_nee = ldn * atten
                srr = srr + torch.where(visible,
                                        mask_r * col_r * lm[27] * w_nee, 0.0)
                srg = srg + torch.where(visible,
                                        mask_g * col_g * lm[28] * w_nee, 0.0)
                srb = srb + torch.where(visible,
                                        mask_b * col_b * lm[29] * w_nee, 0.0)
                if counts is not None:
                    counts["shadow_rays"] += int(nee_cond.sum())
                    counts["shadow_tests"] += int(cast.sum())
                    counts["shadow_lit"] += int(visible.sum())
            direct = no_refr & is_light & (n_hits == 0)
            srr = torch.where(direct, col_r, srr)
            srg = torch.where(direct, col_g, srg)
            srb = torch.where(direct, col_b, srb)
            upd = no_refr & ~is_light
            if sample_tape is not None:
                tape.append(TapeEntry(
                    flags=(no_refr.to(torch.int32) + 2 * upd.to(torch.int32)
                           + 4 * direct.to(torch.int32)),
                    who=torch.where(on_tri, -1 - tri_slot, w),
                    cos=cos, col=(col_r, col_g, col_b),
                    emi=(emi_r, emi_g, emi_b), mask=(mask_r, mask_g, mask_b),
                    uv=uv))
            mask_r = torch.where(upd, mask_r * col_r * cos, mask_r)
            mask_g = torch.where(upd, mask_g * col_g * cos, mask_g)
            mask_b = torch.where(upd, mask_b * col_b * cos, mask_b)
            eff = eff + (rec & ~do_refract & ~any_reflect).to(torch.int32)
            n_hits = n_hits + rec.to(torch.int32)
            alive = (alive & hit_ok & ~(rec & is_light)
                     & (eff < cfg.max_effective_bounces))
            ox = torch.where(rec, nox, ox)
            oy = torch.where(rec, noy, oy)
            oz = torch.where(rec, noz, oz)
            dx = torch.where(rec, ndx, dx)
            dy = torch.where(rec, ndy, dy)
            dz = torch.where(rec, ndz, dz)
            inside = torch.where(rec & do_refract, outside, inside)
        if sample_tape is not None:
            sample_tape(tape)
        acc_r = acc_r + srr
        acc_g = acc_g + srg
        acc_b = acc_b + srb
    return (acc_r.reshape(rows, L), acc_g.reshape(rows, L),
            acc_b.reshape(rows, L))


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "pt_megakernel_launch": (
        [_P] * 13 + [_I] * 7 + [ctypes.c_uint32] + [_I] * 5 + [_F] * 5
        + [_I, _P],
        _I),
    # the textured scenes' entry: the same arguments, then the texel pool
    # and the texture table
    "pt_megakernel_tex_launch": (
        [_P] * 13 + [_I] * 7 + [ctypes.c_uint32] + [_I] * 5 + [_F] * 5
        + [_I, _P, _P, _P],
        _I),
    # the same arguments, then the f32 texels [T, 4], T, the texture
    # table and the walk and leaf codes
    "pt_megakernel_texels_launch": (
        [_P] * 13 + [_I] * 7 + [ctypes.c_uint32] + [_I] * 5 + [_F] * 5
        + [_I, _P, _P, _I, _P, _I, _I],
        _I),
    # NEE: the same arguments, then the texel pool and texture table (null
    # without textures) and the light count and indices
    "pt_megakernel_nee_launch": (
        [_P] * 13 + [_I] * 7 + [ctypes.c_uint32] + [_I] * 5 + [_F] * 5
        + [_I, _P, _P, _P, _I, _P],
        _I),
    # the intersect-only kernel, launched by intersect_batch: the scene's
    # IsectScene (built once, IntersectTables), six ray arrays, the two
    # output buffers (intersect_outputs), the ray count, eps, t_max and
    # the stream
    "pt_intersect_launch": ([_P] * 9 + [_I, _F, _F, _P], _I),
    # the packet walks (Kernels A and B): pt_megakernel_launch's arguments,
    # then the texel pool and texture table (null without textures), the
    # NEE flag, the light count and indices, the MXU fragments (null unless
    # MXU leaves) and the walk and leaf codes (WALK_CODES, LEAF_CODES)
    "pt_megakernel_packet_launch": (
        [_P] * 13 + [_I] * 7 + [ctypes.c_uint32] + [_I] * 5 + [_F] * 5
        + [_I, _P, _P, _P, _I, _I, _P, _P, _I, _I],
        _I),
    # the intersect kernel on the packet walks: pt_intersect_launch's
    # arguments, then the MXU fragments and the walk and leaf codes
    "pt_intersect_packet_launch": (
        [_P] * 9 + [_I, _F, _F, _P, _P, _I, _I], _I),
    # the leaf microbenchmark (P3's counterpart), launched by
    # probes/leaf_bench.py: the rays, their outputs, the visit count, the
    # triangle test and shading tables, MXU fragments, leaf size, leaf
    # count, eps, t_max, the variant code and the stream
    "pt_leaf_bench_launch": (
        [_P] * 6 + [_P, _P, _I, _I] + [_P, _P, _P, _I, _I, _F, _F, _I, _P],
        _I),
    # the texel-fetch probe (P1's counterpart), launched by fetch_texels
    "pt_tex_fetch_launch": (
        [_P] * 6 + [_I] * 5 + [_P], _I),
    # the fetches' wrap against wrap_tex, launched by wrap_check: the first
    # integer, their count, the side, the two uint64 counts and the stream
    "pt_wrap_check_launch": ([ctypes.c_longlong, _I, _I, _P, _P], _I),
    # the light point's sin/cos check, launched by light_sincos: the
    # angles, sin, cos, their count and the stream
    "pt_sincos_launch": ([_P] * 3 + [_I, _P], _I),
    # the object loop's filter against the exact tests, launched by
    # filter_check: the type code, the rays [6, n], thresholds, n, eps, the
    # cylinder's y range, the two uint64 counts and the stream
    "pt_filter_check_launch": ([_I, _P, _P, _I, _F, _F, _F, _P, _P], _I),
    # the frame's finish, launched by finish_frame: the slot sums [3, n],
    # the base slots' pixels, the image, n, the replica stride, the
    # packing, the frame's samples and the stream
    "pt_finish_frame_launch": (
        [_P, _P, _P, _I, _I, _I, ctypes.c_double, _P], _I),
    # the gradient kernel's entries, launched by render/grad.py: object and
    # triangle mode, and texel mode (the texels [T, 4], T, the texture
    # table, gtex [T, 4] and the trainable objects' bit mask; gtri and
    # gtex are [n, 4] rows, rgb and a pad column), each ending in the walk
    # and leaf codes (grad_walk)
    "pt_grad_launch": (
        [_P] * 15 + [_I] * 5 + [ctypes.c_uint32] + [_I] * 5 + [_F] * 5
        + [_I, _P, _I, _I],
        _I),
    "pt_grad_tex_launch": (
        [_P] * 14 + [_I] * 5 + [ctypes.c_uint32] + [_I] * 5 + [_F] * 5
        + [_I, _P, _P, _I, _P, _P, ctypes.c_uint64, _I, _I],
        _I),
}
_MAX_OBJECTS = 64   # kMaxObjects of csrc/megakernel.cu


class IsectScene(ctypes.Structure):
    """csrc/megakernel.cu's IsectScene: what a launch of the
    intersect-only kernel needs of the scene alone (the tables' device
    addresses, the object count, leaf size and octant node count, the type
    codes and group ranges)."""
    _fields_ = [("obj", _P), ("nodes", _P), ("tris", _P), ("shade", _P),
                ("n_obj", _I), ("leaf_size", _I), ("oct_nodes", _I),
                ("obj_types", _I * _MAX_OBJECTS),
                ("group_root", _I * _MAX_OBJECTS),
                ("group_end", _I * _MAX_OBJECTS)]


def library():
    """csrc/megakernel.cu's library, built at first use, with SIGNATURES
    bound (render/_build.py)."""
    return _build.load("megakernel", SIGNATURES)


def trace_tiles(seed, cam_vec, obj_table, node_table, tri_table, shade_table,
                px, py, meta: SceneMeta = None, cfg: RenderConfig = None,
                spp: int = 1, total_samples: int = 1,
                tile: Tuple[int, int] = (64, 256), spp_pack: int = 1,
                pack_axis: str = "row", tex_pool=None, tex_table=None,
                tex_texels=None, out=None):
    """Run the megakernel over all tiles; returns (r, g, b) float32
    radiance sums [T*S, L] on px's device, the planes of one [3, T*S, L]
    buffer: `out` when given (contiguous float32 on px's device), else a
    new one.

    seed = (prng seed, global sample base). spp_pack/pack_axis must match
    the layout (tile_pixel_layout); each slot then sums spp/spp_pack
    samples. A scene with textures takes the texture table and either the
    int32 texel pool (texture_inputs) or f32 texels [T, 3] (tex_texels,
    e.g. scene.pack.texel_params: the differentiable render's texels); one
    without takes none of them. CUDA tensors launch csrc/megakernel.cu on
    the current stream and count the launch in trace_tiles.launches, a
    scene with meshes also in .mesh_launches, one with the pool in
    .tex_launches, one with f32 texels in .texel_launches and one under
    cfg.nee (the shadow-ray instantiation) in .nee_launches; a mesh scene
    under the knobs of mesh_walk also in .packet_launches (the warp-packet
    walk), .mma_launches (its tensor-core leaves) or .ablate_launches (no
    leaf tests), f32 texels on every walk but the tensor-core leaves. CPU
    tensors run trace_tiles_reference. Raises for NEE or MXU leaves with
    f32 texels. The kernel
    keeps every texel index below T
    (the plain version raises IndexError instead), so a table that reaches
    past the texels cannot touch other memory."""
    S, L = tile
    rows = px.shape[0]
    if out is not None and (
            out.dtype != torch.float32 or tuple(out.shape) != (3, rows, L)
            or not out.is_contiguous() or out.device != px.device):
        raise ValueError(f"out must be a contiguous float32 [3, {rows}, "
                         f"{L}] tensor on {px.device}")
    if px.device.type != "cuda":
        rgb = trace_tiles_reference(
            seed, cam_vec, obj_table, node_table, tri_table, shade_table, px,
            py, meta=meta, cfg=cfg, spp=spp, total_samples=total_samples,
            tile=tile, spp_pack=spp_pack, pack_axis=pack_axis,
            tex_pool=tex_pool, tex_table=tex_table, tex_texels=tex_texels)
        if out is None:
            return rgb
        out.copy_(torch.stack(rgb))
        return out[0], out[1], out[2]
    walk = scene_walk(meta)
    seed0, sample_base = _check_args(
        seed, cam_vec, obj_table, node_table, tri_table, shade_table, px, py,
        meta, cfg, spp, tile, spp_pack, pack_axis, tex_pool, tex_table,
        tex_texels, walk)
    n_obj = len(meta.obj_types)
    if not 0 < n_obj <= _MAX_OBJECTS:
        raise ValueError(f"{n_obj} objects; the kernel takes 1..{_MAX_OBJECTS}")
    _check_aligned(node_table=node_table, tri_table=tri_table,
                   shade_table=shade_table)
    lib = library()
    dev = px.device
    if out is None:
        out = torch.empty((3, rows, L), dtype=torch.float32, device=dev)
    # host arrays, copied by value into the launch parameters
    types = (_I * n_obj)(*meta.obj_types)
    roots = (_I * n_obj)(*([-1] * n_obj))
    ends = (_I * n_obj)(*([-1] * n_obj))
    for g, r, e in meta.group_bvh:
        roots[g], ends[g] = r, e
    sun_cut, sun_den, golden2 = _sun_constants(total_samples)
    textured = has_textures(meta)
    lights = nee_lights(meta, cfg)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                px.data_ptr(), py.data_ptr(), obj_table.data_ptr(),
                types, cam_vec.data_ptr(), node_table.data_ptr(),
                tri_table.data_ptr(), shade_table.data_ptr(), roots, ends,
                n_obj, rows * L, S, L, int(spp), spp_pack,
                int(pack_axis == "chunk"), seed0 & _M32, sample_base,
                cfg.max_bounces, cfg.max_effective_bounces, meta.leaf_size,
                meta.n_nodes if meta.octant_orders else 0,
                cfg.epsilon, cfg.t_max, sun_cut, sun_den, golden2,
                int(_coherent_sampling()), stream)
        if textured and tex_texels is not None:
            # the texel gradients' primal, on every walk
            texels4 = texels_padded(tex_texels)
            err = lib.pt_megakernel_texels_launch(
                *args, texels4.data_ptr(), texels4.shape[0],
                tex_table.data_ptr(), WALK_CODES[walk.walk],
                LEAF_CODES[walk.leaf])
        elif walk != Walk():
            # the packet walks (Kernel A; Kernel B with MXU leaves), with
            # or without textures and NEE
            err = lib.pt_megakernel_packet_launch(
                *args, tex_pool.data_ptr() if textured else None,
                tex_table.data_ptr() if textured else None, int(cfg.nee),
                len(lights), (_I * len(lights))(*lights),
                mxu_ptr(tri_table, meta, walk), WALK_CODES[walk.walk],
                LEAF_CODES[walk.leaf])
        elif cfg.nee:
            # the shadow-ray instantiation, also for a scene without a light
            # (no shadow ray then: the render without NEE)
            err = lib.pt_megakernel_nee_launch(
                *args, tex_pool.data_ptr() if textured else None,
                tex_table.data_ptr() if textured else None, len(lights),
                (_I * len(lights))(*lights))
        elif textured:
            err = lib.pt_megakernel_tex_launch(
                *args, tex_pool.data_ptr(), tex_table.data_ptr())
        else:
            err = lib.pt_megakernel_launch(*args)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    trace_tiles.launches += 1
    if meta.has_groups:
        trace_tiles.mesh_launches += 1   # the kernel's BVH-walk instantiation
    if textured and tex_texels is not None:
        trace_tiles.texel_launches += 1  # the f32-texel instantiation
    elif textured:
        trace_tiles.tex_launches += 1    # the texel-fetch instantiation
    if cfg.nee:
        trace_tiles.nee_launches += 1    # the shadow-ray instantiation
    if walk.walk != "thread":
        trace_tiles.packet_launches += 1  # the warp-packet walk (Kernel A)
    if walk.leaf == "mma":
        trace_tiles.mma_launches += 1    # the tensor-core leaves (Kernel B)
    elif walk.leaf == "none":
        trace_tiles.ablate_launches += 1  # the node walk alone
    return out[0], out[1], out[2]


def mxu_ptr(tri_table, meta: SceneMeta, walk: Walk):
    """Device address of the MXU fragments in tri_table (None unless MXU
    leaves)."""
    if walk.leaf != "mma":
        return None
    return tri_table.data_ptr() + meta.n_tri_slots * _TRI_COLS * 4


trace_tiles.launches = 0
trace_tiles.packet_launches = 0
trace_tiles.mma_launches = 0
trace_tiles.ablate_launches = 0
trace_tiles.mesh_launches = 0
trace_tiles.tex_launches = 0
trace_tiles.texel_launches = 0
trace_tiles.nee_launches = 0


def texels_padded(texels: torch.Tensor) -> torch.Tensor:
    """The kernel's layout of f32 texels [T, 3]: [T, 4], rgb and a zero pad
    float, so that a tap is one aligned 16-byte load (a fresh allocation,
    aligned to 256 bytes)."""
    return torch.nn.functional.pad(texels.detach(), (0, 1)).contiguous()


def fetch_texels(pool, base: int, w: int, h: int, u, v, fast: bool = True):
    """Bilinear REPEAT samples of one texture at (base, w, h) in the rgb8
    pool (int32 [T]) at the UVs u, v (f32 [N]): the kernels' own device
    fetch, launched alone (the Hopper counterpart of the JAX package's
    texel-fetch probe, tools/tex_vmem_probe.py); without `fast`, the fetch
    with the JAX kernel's wrap alone. Returns (r, g, b) f32 [N]. CUDA
    tensors launch it and count fetch_texels.launches; CPU tensors run
    sample_pool."""
    if not (0 <= base and base + w * h <= pool.numel() and w > 0 and h > 0):
        raise ValueError(f"texture ({base}, {w}, {h}) is not inside the "
                         f"pool of {pool.numel()} texels")
    for name, t, dtype in (("pool", pool, torch.int32), ("u", u, torch.float32),
                           ("v", v, torch.float32)):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous() \
                or t.device != pool.device:
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} "
                             f"tensor on {pool.device}")
    if u.shape != v.shape:
        raise ValueError("u and v differ in shape")
    if pool.device.type != "cuda":
        f = lambda x: torch.full_like(u, float(x))
        return sample_pool(pool, f(base), f(w), f(h), u, v, fast)
    lib = library()
    out = torch.empty((3, u.numel()), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.pt_tex_fetch_launch(
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            pool.data_ptr(), u.data_ptr(), v.data_ptr(), u.numel(), base, w,
            h, int(fast), torch.cuda.current_stream(u.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"texel fetch launch failed: CUDA error {err}")
    fetch_texels.launches += 1
    return out[0], out[1], out[2]


fetch_texels.launches = 0


def wrap_check(m: int, lo: int, hi: int, device):
    """The fetches' wrap held to the JAX formula (_wrap_tex) by side m on
    every integer a in [lo, hi] (as f32, rounded to nearest): the column
    pair (c0, c1) that wrap_fast and c0 + 1 (0 at m) give, where the fetches
    take it (wrap_is_fast), against _wrap_tex(a) and _wrap_tex(a + 1); the
    cold branch is _wrap_tex itself. Returns (integers wrap_fast takes, how
    many of them differ). On a CUDA device it launches the kernel's own
    wrap (one thread an integer) and counts wrap_check.launches; on the
    CPU it runs wrap_fast."""
    n = hi - lo + 1
    if m < 1 or n < 1 or n >= 2 ** 31:
        raise ValueError(f"side {m} or range [{lo}, {hi}] out of range")
    device = torch.device(device)
    if device.type != "cuda":
        a = (torch.arange(n, dtype=torch.float64) + lo).to(torch.float32)
        fm = torch.full_like(a, float(m))
        fast = wrap_is_fast(a, a, fm, fm)
        a, fm = a[fast], fm[fast]
        c0 = wrap_fast(a, fm, torch.ones_like(fm) / fm)
        c1 = torch.where(c0 + 1.0 == fm, 0.0, c0 + 1.0)
        bad = (c0 != _wrap_tex(a, fm)) | (c1 != _wrap_tex(a + 1.0, fm))
        return int(fast.sum()), int(bad.sum())
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = library().pt_wrap_check_launch(
            lo, n, m, counts.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wrap check launch failed: CUDA error {err}")
    wrap_check.launches += 1
    n_fast, n_bad = counts.tolist()
    return n_fast, n_bad


wrap_check.launches = 0


def light_sincos(x):
    """(sin x, cos x) of the f32 angles x [N] as K1-nee's light point takes
    them: the kernel's light_sincos (one sincosf) launched alone, to hold it
    to torch.sin and torch.cos, the plain version's, over the angles' whole
    range. CUDA tensors launch it and count light_sincos.launches; CPU
    tensors run torch.sin and torch.cos."""
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D float32 tensor")
    if x.device.type != "cuda":
        return torch.sin(x), torch.cos(x)
    out = torch.empty((2, x.numel()), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = library().pt_sincos_launch(
            x.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sin/cos check launch failed: CUDA error {err}")
    light_sincos.launches += 1
    return out[0], out[1]


light_sincos.launches = 0


def filter_check(code: int, ray, thr, eps: float, min_y: float = 0.0,
                 max_y: float = 0.0):
    """The object loop's filter held to the exact tests for objects of type
    `code` (PLANE, SPHERE or CYLINDER, whose y range is min_y, max_y): ray
    f32 [6, n] (object-space o xyz, d xyz) and thresholds thr f32 [n] (each
    above eps). Returns (cases the filter skips, skipped cases whose exact t
    is below the threshold: a winner the loop would miss, which must be 0).
    On a CUDA device it launches the kernel's own filter and tests (one
    thread a case) and counts filter_check.launches; on the CPU it runs
    object_skip and _primitive_t."""
    if code not in (PLANE, SPHERE, CYLINDER):
        raise ValueError(f"no filter for object type {code}")
    if (ray.dtype != torch.float32 or thr.dtype != torch.float32
            or ray.dim() != 2 or ray.shape[0] != 6 or thr.dim() != 1
            or ray.shape[1] != thr.shape[0] or not ray.is_contiguous()
            or not thr.is_contiguous() or ray.device != thr.device):
        raise ValueError("ray must be contiguous float32 [6, n] and thr "
                         "float32 [n] on its device")
    n = thr.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"{n} cases; at most 2^31 - 1 a call")
    if ray.device.type != "cuda":
        skip = object_skip(code, thr, *ray)
        t = _primitive_t(code, [0.0] * 32 + [min_y, max_y], eps, *ray)
        return int(skip.sum()), int((skip & (t < thr)).sum())
    counts = torch.zeros(2, dtype=torch.int64, device=ray.device)
    with torch.cuda.device(ray.device):
        err = library().pt_filter_check_launch(
            code, ray.data_ptr(), thr.data_ptr(), n, eps, min_y, max_y,
            counts.data_ptr(), torch.cuda.current_stream(ray.device)
            .cuda_stream)
    if err != 0:
        raise RuntimeError(f"filter check launch failed: CUDA error {err}")
    filter_check.launches += 1
    n_skip, n_bad = counts.tolist()
    return n_skip, n_bad


filter_check.launches = 0


class ImageLaunch(NamedTuple):
    """trace_tiles' inputs for a whole image on a scene's default tile,
    order and packing: `tables` (camera vector, object table, node,
    triangle and shading tables, slot pixels x and y) go first, `kwargs`
    (tile, spp_pack, pack_axis and the texture inputs) by name; `pid` maps
    the slots back to pixels (untile_image) and `layout_tag` names the
    layout for a checkpoint; `base_pid` (int32 on the launch's device,
    base_slot_pixels) maps each base slot to its pixel for finish_frame,
    and `n_pixels` is the image's W * H."""
    tables: tuple
    kwargs: dict
    pid: np.ndarray
    layout_tag: str
    base_pid: torch.Tensor
    n_pixels: int


def image_launch(scn: SceneArrays, meta: SceneMeta, camera, spp: int,
                 device, tile: Tuple[int, int] = None) -> ImageLaunch:
    """The launch inputs of a whole image of `camera` at `spp` samples a
    launch, the driver's layout policy (default_tile, default_order,
    default_pack clamped to the tile, default_pack_axis), on `device`."""
    W, H = camera.width, camera.height
    S, L = tile if tile is not None else default_tile(meta)
    axis = default_pack_axis(meta)
    pack = clamp_pack(default_pack(meta, spp), S, L, axis)
    order = default_order(meta)
    xs, ys, pid = tile_pixel_layout(W, H, S, L, order=order, spp_pack=pack,
                                    pack_axis=axis)
    tables = tuple(torch.from_numpy(t).to(device) for t in (
        build_camera_vec(camera), build_scene_table(scn, meta),
        *build_mesh_tables(scn, meta), xs, ys))
    kwargs = dict(tile=(S, L), spp_pack=pack, pack_axis=axis,
                  **texture_inputs(scn, meta, device))
    base_pid = torch.from_numpy(
        base_slot_pixels(pid, S, L, pack, axis)).to(device)
    return ImageLaunch(tables, kwargs, pid,
                       "tile%dx%d:%s:pack%d%s" % (S, L, order, pack, axis),
                       base_pid, W * H)


def _check_finish(acc, launch: ImageLaunch, total_spp: int) -> None:
    n_slots = launch.pid.shape[0]
    if (acc.dtype != torch.float32 or tuple(acc.shape) != (3, n_slots)
            or not acc.is_contiguous()
            or acc.device != launch.base_pid.device):
        raise ValueError(f"acc must be a contiguous float32 [3, {n_slots}] "
                         f"tensor on {launch.base_pid.device}")
    if total_spp < 1:
        raise ValueError(f"total_spp {total_spp} must be positive")


def finish_frame(acc, launch: ImageLaunch, total_spp: int):
    """A frame's image from its slot sums: acc [3, slots] f32 (the
    planar sums of launch's layout, summed over the frame's segments)
    -> [n_pixels, 3] f32, each pixel's replicas added in float64 from 0.0
    in slot order, divided by total_spp in float64 and rounded to f32:
    (untile_image(acc.T in float64, pid) / total_spp) cast to f32, bit for
    bit. The tile, packing and axis are launch's. CUDA tensors launch
    csrc/megakernel.cu's finish_frame on the current stream (one thread a
    base slot, so no atomics) and count the launch in
    finish_frame.launches; CPU tensors take the host's finish itself."""
    _check_finish(acc, launch, total_spp)
    if acc.device.type != "cuda":
        # untile_image scatters into W * H pixels: the image as one row
        flat = acc.T.to(torch.float64).numpy()
        img = untile_image(flat, launch.pid, launch.n_pixels, 1)
        return torch.from_numpy((img / float(total_spp)).astype(np.float32))
    S, L = launch.kwargs["tile"]
    pack = launch.kwargs["spp_pack"]
    img = torch.empty((launch.n_pixels, 3), dtype=torch.float32,
                      device=acc.device)
    with torch.cuda.device(acc.device):
        err = library().pt_finish_frame_launch(
            acc.data_ptr(), launch.base_pid.data_ptr(), img.data_ptr(),
            acc.shape[1], replica_stride(S, L, pack,
                                         launch.kwargs["pack_axis"]),
            pack, float(total_spp),
            torch.cuda.current_stream(acc.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"frame finish launch failed: CUDA error {err}")
    finish_frame.launches += 1
    return img


finish_frame.launches = 0


def render_megakernel(scn: SceneArrays, meta: SceneMeta, camera,
                      cfg: RenderConfig, seed: int = None,
                      tile: Tuple[int, int] = None) -> np.ndarray:
    """Full-image render in one launch on the scene's device (counterpart
    of pallas_kernel.render_pallas), with the scene's default order and
    packing. Returns [H, W, 3] float32."""
    W, H = camera.width, camera.height
    run = image_launch(scn, meta, camera, cfg.samples, scn.color.device,
                       tile)
    r, g, b = trace_tiles(
        (seed if seed is not None else cfg.seed, 0), *run.tables,
        meta=meta, cfg=cfg, spp=cfg.samples, total_samples=cfg.samples,
        **run.kwargs)
    img = torch.stack([r, g, b], dim=-1).reshape(-1, 3).cpu().numpy()
    img = untile_image(img, run.pid, W, H).reshape(H, W, 3)
    return img / float(cfg.samples)


# --- intersect-only kernel (K5) ---------------------------------------------

def supports_intersect(meta: SceneMeta) -> bool:
    """Whether intersect_batch takes the scene (pallas_kernel.
    supports_intersect): the four primitives and groups, of any leaf size
    (supports_scene); textures do not matter."""
    return supports_scene(meta)


_TABLE_NAMES = ("obj_table", "node_table", "tri_table", "shade_table")


class IntersectTables(tuple):
    """intersect_tables' result: the object table and the mesh tables
    (nodes, triangle test and shading records), a 4-tuple indexed and
    unpacked as the tables always were, and beside them what a launch
    needs of the scene alone, checked and built once: `meta` (the scene
    they were checked for), `device`, `mesh` (the scene has groups: the
    kernel's mesh instantiation), `scene` (the kernel's IsectScene: the
    tables' addresses, the object count, leaf size and octant node count,
    the type codes and group ranges; `scene_addr` its address) and
    `walks`, the walks whose table shapes were checked (scene_walk is read
    at every call: the knobs may change between calls). Raises as
    intersect_batch's checks do on tables the kernel does not take."""

    def __new__(cls, tables, meta: SceneMeta):
        self = super().__new__(cls, tables)
        if not supports_intersect(meta):
            raise ValueError("intersect_batch takes primitives and groups")
        self.meta = meta
        self.device = getattr(self[0], "device", None) if self else None
        self.mesh = meta.has_groups
        self.walks = set()
        self.check(scene_walk(meta), self.device)
        n_obj = len(meta.obj_types)
        if not 0 < n_obj <= _MAX_OBJECTS:
            raise ValueError(f"{n_obj} objects; the kernel takes "
                             f"1..{_MAX_OBJECTS}")
        sc = IsectScene(*(t.data_ptr() for t in self), n_obj,
                        meta.leaf_size,
                        meta.n_nodes if meta.octant_orders else 0)
        sc.obj_types[:n_obj] = meta.obj_types
        sc.group_root[:n_obj] = sc.group_end[:n_obj] = [-1] * n_obj
        for g, r, e in meta.group_bvh:
            sc.group_root[g], sc.group_end[g] = r, e
        self.scene, self.scene_addr = sc, ctypes.addressof(sc)
        # a scene without groups: its constant triangle outputs, as views
        # of one value for each ray count (intersect_result)
        self.constants = {}
        return self

    def check(self, walk: Walk, device) -> None:
        """_check_tables for a launch on `walk` on `device`, the tables on
        the card 16-byte aligned too; then remember the walk."""
        _check_tables(self, self.meta, walk, device)
        if device.type == "cuda":
            _check_aligned(**dict(zip(_TABLE_NAMES[1:], self[1:])))
        self.walks.add(walk)


def _check_tables(tables, meta: SceneMeta, walk: Walk, device) -> None:
    """Raise unless `tables` are the four contiguous f32 tensors on
    `device` of the shapes a launch on `walk` reads (_table_shapes)."""
    if len(tables) != len(_TABLE_NAMES):
        raise ValueError(f"tables must be {_TABLE_NAMES} (intersect_tables)")
    for name, t, shape in zip(_TABLE_NAMES, tables,
                              _table_shapes(meta, walk)):
        if (not isinstance(t, torch.Tensor) or t.device != device
                or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be a contiguous f32 {shape} "
                             f"tensor on {device}")


def intersect_tables(scn: SceneArrays, meta: SceneMeta, device
                     ) -> IntersectTables:
    """The object table and the mesh tables (build_scene_table,
    build_mesh_tables: nodes, triangle test and shading records) as
    tensors on `device`, with the launch constants of the scene
    (IntersectTables): build them once and hand them to every
    intersect_batch call of a render."""
    return IntersectTables((torch.from_numpy(t).to(device) for t in (
        build_scene_table(scn, meta), *build_mesh_tables(scn, meta))), meta)


def _check_rays(origin, direction):
    """The six ray tensors of origin and direction (3-tuples of contiguous
    f32 [R] tensors of one length on one device); raise on anything
    else."""
    if len(origin) != 3 or len(direction) != 3:
        raise ValueError("origin and direction must be 3-tuples")
    rays = (*origin, *direction)
    try:
        dev, shape = rays[0].device, rays[0].shape
        ok = len(shape) == 1
        for t in rays:
            if (t.dtype is not torch.float32 or t.shape != shape
                    or not t.is_contiguous() or t.device != dev):
                ok = False
    except AttributeError:   # not a tensor
        ok = False
    if not ok:
        raise ValueError("the rays must be contiguous f32 [R] tensors "
                         "of one length on one device")
    return rays


def _intersect_args(meta: SceneMeta, origin, direction, tables, walk: Walk):
    """Validate intersect_batch's arguments for a launch on `walk`; returns
    the six ray tensors."""
    if not supports_intersect(meta):
        raise ValueError("intersect_batch takes primitives and groups")
    rays = _check_rays(origin, direction)
    _check_tables(tables, meta, walk, rays[0].device)
    return rays


def intersect_batch_reference(scn: SceneArrays, meta: SceneMeta,
                              cfg: RenderConfig, origin, direction,
                              tables=None, counts: dict = None):
    """Plain PyTorch version of intersect_batch: the same arguments and
    result, through _nearest_hit. `counts`, when given, gains "rays",
    "node_visits", "leaf_slots", "tri_hits" (rays a triangle won),
    "walk_rays" (rays whose pretest of some group passes, so that they walk
    it), "warps" and "walk_warps" (the warps, 32 rays in flat order, in
    which some ray walks)."""
    dev = origin[0].device
    if tables is None:
        tables = intersect_tables(scn, meta, dev)
    walk = scene_walk(meta)
    ox, oy, oz, dx, dy, dz = _intersect_args(meta, origin, direction, tables,
                                             walk)
    obj = tables[0].detach().cpu().tolist()
    if counts is not None:
        for k in ("rays", "node_visits", "leaf_slots", "tri_hits",
                  "walk_rays", "warps", "walk_warps"):
            counts.setdefault(k, 0)
        counts["rays"] += ox.numel()
    t, w, loc, on_tri, slot, nrm, col = _nearest_hit(
        obj, meta, *tables[1:], cfg.epsilon, cfg.t_max, ox, oy, oz, dx, dy,
        dz, torch.ones_like(ox, dtype=torch.bool), 0, counts, walk,
        walk_groups(ox.numel(), walk, dev))
    if counts is not None:
        counts["tri_hits"] += int(on_tri.sum())
    zero = torch.zeros_like(ox)
    nrm = tuple(torch.where(on_tri, a, zero) for a in nrm)
    col = tuple(torch.where(on_tri, a, zero) for a in col)
    return (torch.clamp(t, max=cfg.t_max), w.to(torch.int32), tuple(loc[:3]),
            tuple(loc[3:]), on_tri, nrm, col,
            torch.where(on_tri, slot, -1).to(torch.int32))


def intersect_outputs(n: int, tables: IntersectTables):
    """The kernel's outputs for n rays, two buffers (csrc/megakernel.cu
    intersect_params): f32 [13, n], the rows t, the object-space origin and
    direction, the triangle normal and color, and i32 [3, n], the winners,
    the triangle slots and the triangle flags (u8, the third row's first n
    bytes); on a scene without groups, whose kernel stores no triangle
    output, f32 [7, n] and i32 [1, n]. The integers have a buffer of their
    own because autograd keeps the winners (an index) and the flags (a
    condition) of every bounce of a differentiable pass, and a view keeps
    its whole buffer alive."""
    mesh, dev = tables.mesh, tables.device
    return (torch.empty((13 if mesh else 7, n), dtype=torch.float32,
                        device=dev),
            torch.empty((3 if mesh else 1, n), dtype=torch.int32,
                        device=dev))


def intersect_result(bufs, tables: IntersectTables):
    """intersect_batch's result from the buffers of intersect_outputs:
    views of them; on a scene without groups the triangle normal and
    color, flag and slot are stride-0 views of one zero, False and -1,
    made once for each ray count (an in-place write on them raises)."""
    f, i = bufs
    t, ox, oy, oz, dx, dy, dz, *tri = f.unbind(0)
    if tables.mesh:
        nx, ny, nz, cr, cg, cb = tri
        idx, slot, flag = i.unbind(0)
        flag = flag.view(torch.uint8)[:f.shape[1]].view(torch.bool)
        return (t, idx, (ox, oy, oz), (dx, dy, dz), flag, (nx, ny, nz),
                (cr, cg, cb), slot)
    n = f.shape[1]
    const = tables.constants.get(n)
    if const is None:
        dev = tables.device
        zero = torch.zeros((), dtype=torch.float32, device=dev).expand(n)
        const = tables.constants[n] = (
            torch.zeros((), dtype=torch.bool, device=dev).expand(n),
            (zero, zero, zero),
            torch.full((), -1, dtype=torch.int32, device=dev).expand(n))
    no_tri, zeros, no_slot = const
    return (t, i[0], (ox, oy, oz), (dx, dy, dz), no_tri, zeros, zeros,
            no_slot)


def _raw_stream(device) -> int:
    """The current CUDA stream of `device`, as the address that
    torch.cuda.current_stream(device).cuda_stream gives, without building
    the Stream object (a twentieth of its host time on the H100's host)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def intersect_launch_args(tables: IntersectTables, rays, bufs, eps: float,
                          t_max: float, walk: Walk):
    """(C entry, its arguments) of one launch of the intersect kernel on
    the six ray tensors `rays` into `bufs` (intersect_outputs) on `walk`,
    on the current stream of the tables' device: fn(*args) launches it
    and returns the CUDA error code. Built once, the call launches again
    with nothing rebuilt (chip_smoke.py times the kernel alone so)."""
    f, i = bufs
    args = (tables.scene_addr, *(t.data_ptr() for t in rays), f.data_ptr(),
            i.data_ptr(), f.shape[1], eps, t_max, _raw_stream(tables.device))
    if walk == _PER_THREAD:
        return library().pt_intersect_launch, args
    return library().pt_intersect_packet_launch, (
        *args, mxu_ptr(tables[2], tables.meta, walk), WALK_CODES[walk.walk],
        LEAF_CODES[walk.leaf])


def intersect_batch(scn: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
                    origin, direction, tables=None):
    """Nearest hit over the whole scene of a flat batch of R rays, with no
    shading (the counterpart of pallas_kernel.intersect_batch, for the
    wavefront integrator). origin and direction are 3-tuples of
    contiguous f32 [R] tensors on one device; `tables` (intersect_tables,
    on that device) are built from `scn` when not given. Returns (t,
    obj_idx, local_origin, local_dir, is_tri, tri_normal, tri_color): t
    f32 [R] (at most cfg.t_max), obj_idx i32 [R] (0 on a miss), the
    winner's object-space ray (the world ray on a miss), is_tri bool [R],
    the winning triangle's smooth normal and color (0 unless a triangle
    won), each Vec3 a 3-tuple of [R] tensors, and tri_slot i32 [R], the
    winning triangle's slot of the mesh tables and of SceneArrays' tri_*
    rows (-1 unless a triangle won). CUDA tensors launch
    csrc/megakernel.cu's intersect kernel on the current stream, one
    thread a ray, and count the launch in intersect_batch.launches (a mesh
    scene under the knobs of mesh_walk: the packet walks, also in
    .packet_launches and, with MXU leaves, .mma_launches); CPU tensors run
    intersect_batch_reference.

    On the card a call checks the rays, allocates the outputs (two
    buffers) and makes one ctypes call: what depends on the scene alone is
    built and checked once, by intersect_tables (tables given as a plain
    4-tuple are checked and built on each call). The walk knobs are read
    at every call. On a scene without groups the kernel stores no
    triangle output: is_tri, tri_normal, tri_color and tri_slot are
    stride-0 views of False, 0 and -1 there."""
    dev = origin[0].device
    if tables is None:
        tables = intersect_tables(scn, meta, dev)
    if dev.type != "cuda":
        return intersect_batch_reference(scn, meta, cfg, origin, direction,
                                         tables)
    if type(tables) is not IntersectTables or (tables.meta is not meta
                                               and tables.meta != meta):
        tables = IntersectTables(tables, meta)
    walk = scene_walk(meta) if tables.mesh else _PER_THREAD
    if walk not in tables.walks:
        tables.check(walk, tables.device)
    rays = _check_rays(origin, direction)
    if rays[0].device != tables.device:
        _check_tables(tables, meta, walk, rays[0].device)
    n = rays[0].shape[0]
    if n > 2 ** 31 - 128:
        raise ValueError(f"{n} rays; the kernel takes at most 2^31 - 128")
    bufs = intersect_outputs(n, tables)
    fn, args = intersect_launch_args(tables, rays, bufs, cfg.epsilon,
                                     cfg.t_max, walk)
    if torch.cuda.current_device() == tables.device.index:
        err = fn(*args)
    else:
        with torch.cuda.device(tables.device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"intersect launch failed: CUDA error {err}")
    intersect_batch.launches += 1
    if walk.walk != "thread":
        intersect_batch.packet_launches += 1
    if walk.leaf == "mma":
        intersect_batch.mma_launches += 1
    return intersect_result(bufs, tables)


intersect_batch.launches = 0
intersect_batch.packet_launches = 0
intersect_batch.mma_launches = 0
