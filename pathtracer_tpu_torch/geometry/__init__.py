"""Pure math core: 4-tuples, 4x4 matrices and transform builders.

numpy float64 host code, copied from pathtracer_tpu.geometry so that this
package never imports the JAX package. Matrix inverses are computed once
at scene-build time and shipped to the device.
"""
from .tuple4 import (
    point,
    vector,
    color,
    is_point,
    is_vector,
    add,
    sub,
    negate,
    mul_scalar,
    div_scalar,
    magnitude,
    normalize,
    dot,
    cross,
    hadamard,
    reflect,
)
from .matrix import (
    identity,
    multiply,
    multiply_tuple,
    transpose,
    determinant,
    submatrix,
    minor,
    cofactor,
    inverse,
)
from .transforms import (
    translate,
    scale,
    rotate_x,
    rotate_y,
    rotate_z,
    shear,
    view_transform,
)

__all__ = [
    "point", "vector", "color", "is_point", "is_vector",
    "add", "sub", "negate", "mul_scalar", "div_scalar",
    "magnitude", "normalize", "dot", "cross", "hadamard", "reflect",
    "identity", "multiply", "multiply_tuple", "transpose",
    "determinant", "submatrix", "minor", "cofactor", "inverse",
    "translate", "scale", "rotate_x", "rotate_y", "rotate_z", "shear",
    "view_transform",
]
