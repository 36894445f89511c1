"""pathtracer_tpu_torch's forward megakernel against the JAX package's on
the mesh scenes `glass` (a 576-triangle goblet), `gopher` and
`gopher-window` (the 1472-triangle stand-in), and on `teapot` with
PT_BVH_LEAF=16, per slot (rule and method: tests/test_torch_mesh_kernel.py).
"""
import pytest
import torch

from _torch_parity import mesh_kernel_parity

torch.set_num_threads(2)


@pytest.mark.parametrize("name,env", [
    ("glass", {}), ("gopher", {}), ("gopher-window", {}),
    ("teapot", {"PT_BVH_LEAF": "16"}),
])
def test_mesh_model_matches_jax_interpret(monkeypatch, name, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mesh_kernel_parity(name)
