"""Axis-aligned bounding boxes (reference: internal/app/shapes/boundingbox.go;
counterpart of pathtracer_tpu.scene.bounds)."""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from .shapes import Shape


class BoundingBox:
    def __init__(self, min_p: np.ndarray, max_p: np.ndarray):
        self.min = np.asarray(min_p, dtype=np.float64).copy()
        self.max = np.asarray(max_p, dtype=np.float64).copy()

    @staticmethod
    def empty() -> "BoundingBox":
        return BoundingBox(
            np.array([np.inf, np.inf, np.inf, 1.0]),
            np.array([-np.inf, -np.inf, -np.inf, 1.0]),
        )

    @staticmethod
    def of_floats(x1, y1, z1, x2, y2, z2) -> "BoundingBox":
        return BoundingBox(
            np.array([x1, y1, z1, 1.0]), np.array([x2, y2, z2, 1.0])
        )

    def contains_point(self, p: np.ndarray) -> bool:
        return bool(
            np.all(self.min[:3] <= p[:3]) and np.all(self.max[:3] >= p[:3])
        )

    def contains_box(self, b: "BoundingBox") -> bool:
        return self.contains_point(b.min) and self.contains_point(b.max)

    def add_point(self, p: np.ndarray) -> None:
        self.min[:3] = np.minimum(self.min[:3], p[:3])
        self.max[:3] = np.maximum(self.max[:3], p[:3])

    def is_empty(self) -> bool:
        return bool(np.any(self.min[:3] > self.max[:3]))

    def merge_with(self, b: "BoundingBox") -> None:
        # an empty box adds nothing (its corners are +inf/-inf)
        if not b.is_empty():
            self.add_point(b.min)
            self.add_point(b.max)


def transform_bounding_box(bbox: BoundingBox, m: np.ndarray) -> BoundingBox:
    """Transform all 8 corners and re-box (boundingbox.go:67). An empty box
    stays empty: transforming its infinite corners would give NaN (0 * inf),
    and a NaN bound hides the whole group from the kernel's bbox pretest.
    The JAX package's Python path has that fault for every parsed model,
    whose "DefaultGroup" is empty (ROADMAP queue 3)."""
    mn, mx = bbox.min, bbox.max
    out = BoundingBox.empty()
    if bbox.is_empty():
        return out
    for x in (mn[0], mx[0]):
        for y in (mn[1], mx[1]):
            for z in (mn[2], mx[2]):
                p = m @ np.array([x, y, z, 1.0])
                out.add_point(p)
    return out


def bounds_of(shape: "Shape") -> BoundingBox:
    """Per-shape local-space bounds (boundingbox.go:89 BoundsOf):
    Group -> recursive over children's parent-space bounds,
    Triangle -> from vertices, default -> unit box."""
    from .shapes import Group, Triangle

    if isinstance(shape, Group):
        box = BoundingBox.empty()
        if shape.soup is not None:
            # a parsed model: the box the Python parser's group of groups
            # gets, each group's vertex box through its identity transform
            for pts in shape.soup.group_points():
                sub = BoundingBox.empty()
                sub.add_point(pts.min(axis=0))
                sub.add_point(pts.max(axis=0))
                box.merge_with(transform_bounding_box(sub, np.eye(4)))
        # untransformed triangles bound their vertices: one vectorised
        # min/max over all of them instead of eight corner transforms each
        eye = np.eye(4)
        flat = [c for c in shape.children if isinstance(c, Triangle)
                and np.array_equal(c.transform, eye)]
        if flat:
            pts = np.stack([p[:3] for t in flat for p in (t.p1, t.p2, t.p3)])
            box.add_point(pts.min(axis=0))
            box.add_point(pts.max(axis=0))
        for c in shape.children:
            if not (isinstance(c, Triangle)
                    and np.array_equal(c.transform, eye)):
                box.merge_with(parent_space_bounds(c))
        return box
    if isinstance(shape, Triangle):
        box = BoundingBox.empty()
        box.add_point(shape.p1)
        box.add_point(shape.p2)
        box.add_point(shape.p3)
        return box
    return BoundingBox.of_floats(-1, -1, -1, 1, 1, 1)


def parent_space_bounds(shape: "Shape") -> BoundingBox:
    """Local bounds transformed into the parent's space (boundingbox.go:62)."""
    return transform_bounding_box(bounds_of(shape), shape.transform)
