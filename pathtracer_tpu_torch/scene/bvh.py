"""Flat skip-link BVH over triangles (counterpart of
pathtracer_tpu.scene.bvh, the builder ``pack_scene`` uses).

``build_bvh`` builds a binary BVH directly over triangle arrays and emits
it in depth-first order with *skip links* (escape indices), so the device
walk is a stackless loop with one integer of state per ray:

    idx = root
    while idx < end:
        hit = slab_test(node[idx])
        if hit and node is leaf: test its LEAF_SIZE triangle slots
        idx = hit ? idx + 1 : exit[idx]

Every leaf owns exactly LEAF_SIZE contiguous triangle slots, padded with
degenerate all-zero triangles that never pass the determinant test.

The build takes the host scene core (native.py, csrc/scenecore.cpp),
whose splits and emit equal, bit for bit, the NumPy builder's here
(`_emit_python`, the JAX package's NumPy path), which stays as the plain
version and runs under PT_NATIVE=0.

The reference-parity group ``divide`` (internal/app/shapes/bvh.go:9-119:
a recursive median split of the longest axis into left, right and
remaining subgroups) is here too, as the JAX module has it, for scenes and
tests that call it; ``pack_scene`` does not.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional, Tuple

import numpy as np

from .bounds import BoundingBox, bounds_of, parent_space_bounds
from .shapes import Group, Shape, Triangle


# --- reference-parity group divide (bvh.go) --------------------------------

def split_bounds(b: BoundingBox) -> Tuple[BoundingBox, BoundingBox]:
    """Split a box perpendicular to its longest axis (bvh.go:9 SplitBounds)."""
    d = b.max[:3] - b.min[:3]
    axis = int(np.argmax(d))
    mid = b.min[axis] + d[axis] / 2.0

    left_max = b.max.copy()
    left_max[axis] = mid
    right_min = b.min.copy()
    right_min[axis] = mid
    return BoundingBox(b.min, left_max), BoundingBox(right_min, b.max)


def partition_children(g: Group) -> Tuple[Group, Group]:
    """Partition children into left/right/remain (bvh.go:51)."""
    left, right = Group(), Group()
    lb, rb = split_bounds(bounds_of(g))

    remain: List[Shape] = []
    for c in g.children:
        cb = parent_space_bounds(c)
        if lb.contains_box(cb):
            left.add_child(c)
        elif rb.contains_box(cb):
            right.add_child(c)
        else:
            remain.append(c)
    g.children = remain
    g.bounds()
    left.bounds()
    right.bounds()
    return left, right


def make_sub_group(g: Group, shapes: List[Shape]) -> None:
    """Wrap shapes in a new subgroup of g (bvh.go:81 MakeSubGroup)."""
    sub = Group()
    sub.material = g.material
    for s in shapes:
        sub.add_child(s)
    g.add_child(sub)


def divide(s: Shape, threshold: int) -> None:
    """Recursive top-down BVH divide (bvh.go:92-119)."""
    if not isinstance(s, Group):
        return
    if threshold <= len(s.children):
        left, right = partition_children(s)
        if left.children:
            make_sub_group(s, left.children)
        if right.children:
            make_sub_group(s, right.children)
    for c in s.children:
        divide(c, threshold)

@dataclasses.dataclass
class FlatBVH:
    """One global flat node/triangle pool shared by all group objects
    (the TPU equivalent of the reference's global CLGroup/CLTriangle
    arrays, internal/ocl/scene.go:8-12)."""
    node_bb_min: np.ndarray   # [Nn, 3] f64
    node_bb_max: np.ndarray   # [Nn, 3]
    node_tri_start: np.ndarray  # [Nn] i32 (leaf slot offset; 0 for internal)
    node_is_leaf: np.ndarray    # [Nn] i32 (1 leaf, 0 internal)
    node_exit: np.ndarray       # [Nn] i32 skip link
    # triangle slots, LEAF_SIZE-aligned, degenerate-padded
    tri_p1: np.ndarray        # [Nt, 3]
    tri_e1: np.ndarray
    tri_e2: np.ndarray
    tri_n1: np.ndarray
    tri_n2: np.ndarray
    tri_n3: np.ndarray
    tri_color: np.ndarray     # [Nt, 3]
    leaf_size: int

    @property
    def n_nodes(self) -> int:
        return self.node_bb_min.shape[0]

    @property
    def n_tri_slots(self) -> int:
        return self.tri_p1.shape[0]


class _Node:
    __slots__ = ("bb_min", "bb_max", "left", "right", "tri_ids")

    def __init__(self):
        self.bb_min = None
        self.bb_max = None
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None
        self.tri_ids: Optional[np.ndarray] = None


def _build_tree(bb_min, bb_max, centroids, ids, leaf_size) -> _Node:
    """Snapped-SAH top-down build.

    Split choice is SAH (minimize area_L*count_L + area_R*count_R over the
    sorted-centroid sweeps of all 3 axes) with the cut SNAPPED to a
    multiple of leaf_size. The snap matters because of the device cost
    model: packet traversal (_packet_traverse) pays one while-iteration
    per visited node and leaves cost a FIXED vectorized unroll regardless
    of occupancy, so every leaf should be completely full — a snapped tree
    has the minimum possible ceil(N/leaf_size) leaves / 2*ceil(..)-1
    nodes. On teapot/gopher this cuts bounce-packet iterations ~1.3x at
    equal leaf size vs the previous median-count split (and the fuller
    leaves shrink the padded triangle pool as well); see
    tools/bvh_experiment.py.

    Deterministic: stable sorts, fixed operation order, strict-< first-min
    tie-breaking over axes then cut positions.
    """
    node = _Node()
    node.bb_min = bb_min[ids].min(axis=0)
    node.bb_max = bb_max[ids].max(axis=0)
    if len(ids) <= leaf_size:
        node.tri_ids = ids
        return node

    c = centroids[ids]
    cmin = c.min(axis=0)
    cmax = c.max(axis=0)
    n = len(ids)
    n_leaves = -(-n // leaf_size)
    best_cost = np.inf
    best_order = None
    best_cut = 0
    for axis in range(3):
        if cmax[axis] - cmin[axis] <= 0.0:
            continue
        order = np.argsort(c[:, axis], kind="stable")
        smin = bb_min[ids[order]]
        smax = bb_max[ids[order]]
        lmn = np.minimum.accumulate(smin, axis=0)
        lmx = np.maximum.accumulate(smax, axis=0)
        rmn = np.minimum.accumulate(smin[::-1], axis=0)[::-1]
        rmx = np.maximum.accumulate(smax[::-1], axis=0)[::-1]
        cuts = np.arange(leaf_size, n, leaf_size)

        def _area(mn, mx):
            d = mx - mn
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        cost = (_area(lmn[cuts - 1], lmx[cuts - 1]) * cuts
                + _area(rmn[cuts], rmx[cuts]) * (n - cuts))
        k = int(np.argmin(cost))
        if cost[k] < best_cost:
            best_cost = float(cost[k])
            best_order = order
            best_cut = int(cuts[k])
    if best_order is None:
        # all centroids identical: snapped even split, original order
        best_order = np.arange(n)
        best_cut = min(leaf_size * (n_leaves // 2), n - 1)
    node.left = _build_tree(bb_min, bb_max, centroids,
                            ids[best_order[:best_cut]], leaf_size)
    node.right = _build_tree(bb_min, bb_max, centroids,
                             ids[best_order[best_cut:]], leaf_size)
    return node


def triangle_boxes(p1, p2, p3):
    """Each triangle's box and centroid ([N, 3] each): the builder's
    inputs."""
    return (np.minimum(np.minimum(p1, p2), p3),
            np.maximum(np.maximum(p1, p2), p3), (p1 + p2 + p3) / 3.0)


def _emit_python(bb_min, bb_max, centroids, n_tris: int, leaf_size: int):
    """Pure-Python DFS emit. Returns local-indexed arrays + slot tri ids
    (-1 padding)."""
    root = _build_tree(bb_min, bb_max, centroids, np.arange(n_tris),
                       leaf_size)

    rec_bb_min: List[np.ndarray] = []
    rec_bb_max: List[np.ndarray] = []
    rec_start: List[int] = []
    rec_leaf: List[int] = []
    rec_exit: List[int] = []
    slots: List[int] = []

    def emit(n: _Node) -> None:
        my = len(rec_bb_min)
        rec_bb_min.append(n.bb_min)
        rec_bb_max.append(n.bb_max)
        rec_exit.append(0)  # fixed after the subtree is emitted
        if n.tri_ids is not None:
            rec_leaf.append(1)
            rec_start.append(len(slots))
            slots.extend(int(t) for t in n.tri_ids)
            slots.extend([-1] * (leaf_size - len(n.tri_ids)))
        else:
            rec_leaf.append(0)
            rec_start.append(0)
            emit(n.left)
            emit(n.right)
        # skip link: first node after this node's entire subtree
        rec_exit[my] = len(rec_bb_min)

    emit(root)
    return (np.stack(rec_bb_min), np.stack(rec_bb_max),
            np.asarray(rec_start, dtype=np.int32),
            np.asarray(rec_leaf, dtype=np.int32),
            np.asarray(rec_exit, dtype=np.int32),
            np.asarray(slots, dtype=np.int32))


def build_bvh_arrays(
    p1: np.ndarray, p2: np.ndarray, p3: np.ndarray,
    n1: np.ndarray, n2: np.ndarray, n3: np.ndarray,
    color: np.ndarray,
    leaf_size: int = 8,
    into: Optional[FlatBVH] = None,
) -> Tuple[FlatBVH, int, int]:
    """Build a skip-link BVH over triangle-soup arrays ([N,3] each),
    appending to the global pool ``into``, with the scene core unless
    PT_NATIVE=0 (the same pool either way). Returns (pool, root_index,
    end_index)."""
    from .. import native

    node_base = into.n_nodes if into is not None else 0
    slot_base = into.n_tri_slots if into is not None else 0

    if native.available():
        bmin, bmax, start, leaf, exit_, slots = native.build_bvh(
            p1, p2, p3, leaf_size)
    else:
        bmin, bmax, start, leaf, exit_, slots = _emit_python(
            *triangle_boxes(p1, p2, p3), p1.shape[0], leaf_size)

    # Inflate node boxes slightly: axis-flat geometry (e.g. a wall of
    # coplanar triangles) yields zero-extent boxes that fail the strict
    # tmin < tmax slab test — a documented flaw in the reference
    # (tracer.cl:605-606 "BB must have extent in all 3-axises"); padding
    # the boxes at build time fixes it with no traversal cost.
    pad = 1e-4
    bmin = bmin - pad
    bmax = bmax + pad
    # rebase local indices into the global pool
    start = np.where(leaf == 1, start + slot_base, start).astype(np.int32)
    exit_ = (exit_ + node_base).astype(np.int32)

    # gather slot fields; padding slots (-1) become degenerate all-zero
    # triangles that can never pass the Möller–Trumbore determinant test
    valid = slots >= 0
    idx = np.clip(slots, 0, None)

    def g(a: np.ndarray) -> np.ndarray:
        out = a[idx]
        out[~valid] = 0.0
        return out

    gp1 = g(p1)
    new = FlatBVH(
        node_bb_min=bmin,
        node_bb_max=bmax,
        node_tri_start=start,
        node_is_leaf=leaf,
        node_exit=exit_,
        tri_p1=gp1,
        tri_e1=g(p2) - gp1,
        tri_e2=g(p3) - gp1,
        tri_n1=g(n1),
        tri_n2=g(n2),
        tri_n3=g(n3),
        tri_color=g(color),
        leaf_size=leaf_size,
    )

    if into is None:
        return new, node_base, node_base + new.n_nodes
    return _merge(into, new), node_base, node_base + new.n_nodes


def build_bvh(
    triangles: List[Triangle],
    leaf_size: int = 8,
    into: Optional[FlatBVH] = None,
) -> Tuple[FlatBVH, int, int]:
    """Build a skip-link BVH over Triangle objects (converts to soup
    arrays and delegates to build_bvh_arrays)."""
    p1 = np.stack([t.p1[:3] for t in triangles])
    p2 = np.stack([t.p2[:3] for t in triangles])
    p3 = np.stack([t.p3[:3] for t in triangles])
    n1 = np.stack([t.n1[:3] for t in triangles])
    n2 = np.stack([t.n2[:3] for t in triangles])
    n3 = np.stack([t.n3[:3] for t in triangles])
    color = np.stack([np.asarray(t.material.color)[:3] for t in triangles])
    return build_bvh_arrays(p1, p2, p3, n1, n2, n3, color,
                            leaf_size=leaf_size, into=into)


def octant_node_orders(pool: FlatBVH, segments) -> FlatBVH:
    """Append 8 octant-ordered copies of the node pool (near-child-first
    DFS per ray-direction octant).

    The walk visits nodes in the FIXED skip-link order; its best-t pruning
    (`tmin < bt`) only skips leaves behind hits it has already found.
    Visiting the NEAR child first for the ray's direction octant finds
    hits earlier, so far leaves prune sooner — the equivalent of ordered
    traversal with a stack (the reference's stack walk,
    tracer.cl:624-718, has the same fixed-order limitation). The JAX
    kernel picks the copy by the packet's majority octant, this package's
    kernel by each ray's own.

    Returns a FlatBVH whose node arrays are [9*Nn]: copy 0 is the
    ORIGINAL DFS order (for any consumer indexing roots directly), copies
    1..8 are octants 0..7 (octant bit a set = ray direction negative
    along axis a). Roots/exits within copy k live at [k*Nn, (k+1)*Nn).
    `segments` is the group (root, end) list — each group's subtree is
    reordered independently.
    """
    nn = pool.n_nodes
    bmin = pool.node_bb_min
    bmax = pool.node_bb_max
    start = pool.node_tri_start
    leaf = pool.node_is_leaf
    exit_ = pool.node_exit

    copies_min = [bmin]
    copies_max = [bmax]
    copies_start = [start]
    copies_leaf = [leaf]
    copies_exit = [exit_]
    cent = (bmin + bmax) * 0.5

    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 10000))
    try:
        for o in range(8):
            o_min = np.empty_like(bmin)
            o_max = np.empty_like(bmax)
            o_start = np.empty_like(start)
            o_leaf = np.empty_like(leaf)
            o_exit = np.empty_like(exit_)
            pos = 0

            for (root, end) in segments:
                base = root  # segment-local layout preserved per copy

                def emit(i):
                    nonlocal pos
                    my = pos
                    pos += 1
                    o_min[my] = bmin[i]
                    o_max[my] = bmax[i]
                    o_start[my] = start[i]
                    o_leaf[my] = leaf[i]
                    if not leaf[i]:
                        a = i + 1
                        b = int(exit_[a])
                        axis = int(np.argmax(np.abs(cent[b] - cent[a])))
                        far_is_b = cent[b][axis] >= cent[a][axis]
                        if (o >> axis) & 1:       # majority dir negative
                            far_is_b = not far_is_b
                        near, far = (a, b) if far_is_b else (b, a)
                        emit(near)
                        emit(far)
                    o_exit[my] = pos

                assert pos == base, (pos, base)
                emit(root)
                assert pos == end, (pos, end)

            copies_min.append(o_min)
            copies_max.append(o_max)
            copies_start.append(o_start)
            copies_leaf.append(o_leaf)
            copies_exit.append(o_exit + np.int32(0))
    finally:
        sys.setrecursionlimit(limit)

    # rebase exits of copy k by k*nn
    all_exit = [copies_exit[0]] + [
        (copies_exit[k] + k * nn).astype(np.int32) for k in range(1, 9)
    ]
    return dataclasses.replace(
        pool,
        node_bb_min=np.concatenate(copies_min),
        node_bb_max=np.concatenate(copies_max),
        node_tri_start=np.concatenate(copies_start).astype(np.int32),
        node_is_leaf=np.concatenate(copies_leaf).astype(np.int32),
        node_exit=np.concatenate(all_exit).astype(np.int32),
    )


def _merge(into: FlatBVH, new: FlatBVH) -> FlatBVH:
    merged = FlatBVH(
        node_bb_min=np.concatenate([into.node_bb_min, new.node_bb_min]),
        node_bb_max=np.concatenate([into.node_bb_max, new.node_bb_max]),
        node_tri_start=np.concatenate([into.node_tri_start, new.node_tri_start]),
        node_is_leaf=np.concatenate([into.node_is_leaf, new.node_is_leaf]),
        node_exit=np.concatenate([into.node_exit, new.node_exit]),
        tri_p1=np.concatenate([into.tri_p1, new.tri_p1]),
        tri_e1=np.concatenate([into.tri_e1, new.tri_e1]),
        tri_e2=np.concatenate([into.tri_e2, new.tri_e2]),
        tri_n1=np.concatenate([into.tri_n1, new.tri_n1]),
        tri_n2=np.concatenate([into.tri_n2, new.tri_n2]),
        tri_n3=np.concatenate([into.tri_n3, new.tri_n3]),
        tri_color=np.concatenate([into.tri_color, new.tri_color]),
        leaf_size=new.leaf_size,
    )
    return merged


def empty_bvh(leaf_size: int = 8) -> FlatBVH:
    z3 = np.zeros((0, 3), dtype=np.float64)
    zi = np.zeros((0,), dtype=np.int32)
    return FlatBVH(z3, z3, zi, zi, zi, z3, z3, z3, z3, z3, z3, z3, leaf_size)
