"""The benchmark's plain reference: the renderer's semantics in plain
PyTorch and NumPy, built from the benchmark's own inputs (a configuration
file and the .obj text the benchmark writes).

Nothing here imports the program under test (`pathtracer_tpu_torch`), JAX
or the JAX package, and nothing here takes a table, a BVH or a layout the
program made: `scene` builds the object table, the camera and the mesh
tables, `bvh` its own BVH, `layout` the slot layout and the segment
schedule, `trace` the paths. Where a piece is a frozen copy of the
program's plain version, its module header names the file and commit.
"""
