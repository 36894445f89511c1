"""Host-side scene graph, materials, .obj parsing, the BVH builder and
packing to the device scene layout (untextured scenes of primitives and
triangle meshes)."""
from .material import Material
from .shapes import Plane, Sphere, Cube, Cylinder, Triangle, Group, Shape
from .pack import SceneArrays, SceneMeta, Scene, pack_scene, from_jax_scene

__all__ = [
    "Material",
    "Plane", "Sphere", "Cube", "Cylinder", "Triangle", "Group", "Shape",
    "SceneArrays", "SceneMeta", "Scene", "pack_scene", "from_jax_scene",
]
