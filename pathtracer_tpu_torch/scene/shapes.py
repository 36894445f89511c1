"""Host-side scene-graph shapes (counterpart of pathtracer_tpu.scene.shapes).

Semantics mirror the reference (internal/app/shapes/): every shape carries a
transform plus cached inverse/inverse-transpose, and ``set_transform``
RIGHT-multiplies the new matrix onto the existing transform and recomputes
the caches (sphere.go:60-64). All primitive geometry is defined on the unit
shape in object space.

Type codes match the reference's CL layout (internal/ocl/scene.go:45-76):
0 plane, 1 sphere, 2 cylinder, 3 box, 4 group.

Groups of triangles (meshes) carry their cached bounds as in the JAX
package. A model parsed by the scene core (native.py) is a Group whose
triangles are arrays, `Group.soup` (a native.ObjData), with no children;
`all_triangles()` builds Triangle objects from it for a reader that needs
them, and its bounds are those of the Python parser's group of groups.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..geometry import matrix as gm
from ..geometry import tuple4 as gt
from .material import Material

PLANE, SPHERE, CYLINDER, BOX, GROUP = 0, 1, 2, 3, 4


class Shape:
    type_code: int = -1

    def __init__(self, material: Optional[Material] = None, label: str = ""):
        self.transform = gm.identity()
        self.inverse = gm.identity()
        self.inverse_transpose = gm.identity()
        self.material = material if material is not None else Material.default()
        self.label = label
        self.parent: Optional["Shape"] = None

    def set_transform(self, m: np.ndarray) -> "Shape":
        """Right-multiply accumulate, recompute inverse caches
        (reference sphere.go:60-64)."""
        self.transform = self.transform @ m
        self.inverse = gm.inverse(self.transform)
        self.inverse_transpose = self.inverse.T.copy()
        return self

    def set_material(self, m: Material) -> "Shape":
        self.material = m
        return self


class Plane(Shape):
    """Infinite XZ plane through the origin (shapes/plane.go)."""
    type_code = PLANE

    def __init__(self, **kw):
        super().__init__(**kw)
        # The reference's default plane material is white diffuse.
        self.material = kw.get("material") or Material.default()


class Sphere(Shape):
    """Unit sphere at the origin (shapes/sphere.go:14)."""
    type_code = SPHERE

    def __init__(self, **kw):
        super().__init__(**kw)
        if "material" not in kw or kw["material"] is None:
            # reference default: color (1, .5, .5)
            self.material = Material(color=(1.0, 0.5, 0.5))


class Cube(Shape):
    """Unit cube spanning [-1, 1]^3 (shapes/cube.go:9)."""
    type_code = BOX


class Cylinder(Shape):
    """Infinite unit cylinder about the Y axis, truncated to
    (min_y, max_y) (shapes/cylinder.go:28-41)."""
    type_code = CYLINDER

    def __init__(self, min_y: float = -np.inf, max_y: float = np.inf,
                 closed: bool = False, **kw):
        super().__init__(**kw)
        self.min_y = float(min_y)
        self.max_y = float(max_y)
        self.closed = closed


class Triangle(Shape):
    """Triangle with precomputed edges and face/vertex normals
    (shapes/triangle.go:21-88). Face normal n = normalize(cross(e2, e1))."""
    type_code = -2  # triangles are never top-level device objects

    def __init__(self, p1, p2, p3, n1=None, n2=None, n3=None, **kw):
        super().__init__(**kw)
        self.p1 = np.asarray(p1, dtype=np.float64)
        self.p2 = np.asarray(p2, dtype=np.float64)
        self.p3 = np.asarray(p3, dtype=np.float64)
        self.e1 = self.p2 - self.p1
        self.e2 = self.p3 - self.p1
        cr = gt.cross(self.e2, self.e1)
        mag = float(gt.magnitude(cr))
        self.n = cr / mag if mag > 0.0 else cr  # degenerate pad triangles
        self.n1 = np.asarray(n1, dtype=np.float64) if n1 is not None else self.n
        self.n2 = np.asarray(n2, dtype=np.float64) if n2 is not None else self.n
        self.n3 = np.asarray(n3, dtype=np.float64) if n3 is not None else self.n


class Group(Shape):
    """Scene-graph node with children and a cached AABB updated on add_child
    (shapes/group.go:123-134)."""
    type_code = GROUP

    def __init__(self, **kw):
        super().__init__(**kw)
        self.children: List[Shape] = []
        # a parsed model's triangles as arrays (native.ObjData), or None
        self.soup = None
        from .bounds import BoundingBox
        self.bounding_box = BoundingBox.empty()

    def add_child(self, s: Shape) -> None:
        from .bounds import bounds_of
        self.children.append(s)
        s.parent = self
        self.bounding_box.merge_with(bounds_of(s))

    def add_children(self, *shapes: Shape) -> None:
        for s in shapes:
            self.add_child(s)

    def bounds(self) -> None:
        """Recompute the cached AABB (group.go:134)."""
        from .bounds import bounds_of
        self.bounding_box = bounds_of(self)

    def all_triangles(self) -> List[Triangle]:
        """All descendant triangles in depth-first order, a soup's first."""
        out: List[Triangle] = (self.soup.triangles()
                               if self.soup is not None else [])
        for c in self.children:
            if isinstance(c, Triangle):
                out.append(c)
            elif isinstance(c, Group):
                out.extend(c.all_triangles())
        return out

    def n_triangles(self) -> int:
        """len(all_triangles()), without building a soup's triangles."""
        n = self.soup.n_tris if self.soup is not None else 0
        for c in self.children:
            if isinstance(c, Triangle):
                n += 1
            elif isinstance(c, Group):
                n += c.n_triangles()
        return n


def flatten(group: Group) -> List[Shape]:
    """Flatten a group hierarchy into a list of non-group shapes
    (shapes/flatten.go — vestigial in the reference, kept for parity)."""
    out: List[Shape] = (group.soup.triangles()
                        if group.soup is not None else [])
    for c in group.children:
        if isinstance(c, Group):
            out.extend(flatten(c))
        else:
            out.append(c)
    return out
