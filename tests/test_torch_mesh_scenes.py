"""pathtracer_tpu_torch's forward megakernel against the JAX package's on
the mesh scenes `default` (a 3-triangle group), `christian` and
`transparent_teapot` (the 1472-triangle teapot stand-in), and on `teapot`
with PT_SPP_PACK=2, per slot (rule and method: tests/test_torch_mesh_kernel.py).
"""
import pytest
import torch

from _torch_parity import mesh_kernel_parity

torch.set_num_threads(2)


@pytest.mark.parametrize("name,env", [
    ("default", {}), ("christian", {}), ("transparent_teapot", {}),
    ("teapot", {"PT_SPP_PACK": "2"}),        # 2 replicas of 256 lanes
])
def test_mesh_scene_matches_jax_interpret(monkeypatch, name, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mesh_kernel_parity(name)
