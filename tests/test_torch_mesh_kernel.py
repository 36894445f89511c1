"""pathtracer_tpu_torch's forward megakernel on `teapot` (a 1472-triangle
UV sphere stands in for teapot.obj) against the JAX package's, per slot.

On the CPU the port's trace_tiles runs its plain PyTorch version, with the
per-ray BVH walk; it is held against pallas_kernel.trace_tiles(interpret=
True) with the same seed vector, the driver's mesh layout (tile (8, 512),
block order, 4 sample replicas on the 128-lane chunks) and total_samples
(_torch_parity.mesh_kernel_parity). Rule: >= 99% of slot values within
atol=1e-4, rtol=1e-3, each image-mean channel within 1%. The walks differ
in order only (one pointer per packet there, one per ray here), which
matters only on exact-t ties.

The CUDA kernel itself is held against the plain version, bit for bit, by
tests/test_torch_cuda.py, which needs a card.
"""
import pytest
import torch

from _torch_parity import mesh_kernel_parity

torch.set_num_threads(2)


@pytest.mark.parametrize("aperture,base,env", [
    (0.0, 0, {}),
    (0.1, 16, {}),                           # sunflower DoF over replicas
    (0.0, 0, {"PT_PACK_AXIS": "row"}),       # 8 replicas on the tile rows
    (0.0, 0, {"PT_OCTANT": "0"}),            # one node order for all rays
])
def test_teapot_matches_jax_interpret(monkeypatch, aperture, base, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mesh_kernel_parity("teapot", aperture=aperture, base=base)
