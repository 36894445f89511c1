"""make_sharded_train_step (the wavefront autograd path over a mesh)
against the JAX package's on a (2, 2) CPU mesh, on `reference`.

One process plays both ranks (parallel.mesh.LogicalMesh); the JAX step
runs shard_map over four virtual devices. Each rank takes its contiguous
slice of the pixels under fold_in(fold_in(key, pix_rank), spp_rank), the
port's threefry bit for bit, so both trace the same paths: the loss within
1e-6 relative and each parameter's update within the gradient rule of
tests/_torch_scenes.py (GRAD_REL of the largest entry). A torch.optim
optimizer takes optax's place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_pack, scene_pair
from _torch_scenes import GRAD_REL
from pathtracer_tpu.diff.grad import extract_params as jax_params
from pathtracer_tpu.diff.grad import make_sharded_train_step as jax_step
from pathtracer_tpu.parallel import make_mesh as jax_mesh
from pathtracer_tpu.render.vec3 import Vec3 as JVec3
from pathtracer_tpu_torch.diff import extract_params, make_sharded_train_step
from pathtracer_tpu_torch.parallel.mesh import LogicalMesh
from pathtracer_tpu_torch.render import threefry
from pathtracer_tpu_torch.render.vec3 import Vec3

torch.set_num_threads(2)

W, H = 16, 12
FIELDS = ("color", "emission")


@pytest.fixture(scope="module")
def case():
    js, jc, ts, tc = scene_pair("reference", width=W, height=H, samples=2,
                                samples_per_pass=2)
    ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device=torch.device("cpu"))
    ys, xs = np.mgrid[0:H, 0:W]
    px, py = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
    target = np.random.default_rng(2).random((3, W * H)).astype(np.float32)
    return dict(
        jax=(ja, jm, jc, js.camera.pack(jnp.float32), jnp.asarray(px),
             jnp.asarray(py), JVec3(*map(jnp.asarray, target))),
        port=(ta, tm, tc, ts.camera.pack(torch.float32, "cpu"),
              torch.from_numpy(px), torch.from_numpy(py),
              Vec3(*map(torch.from_numpy, target))))


def test_sharded_train_step_matches_jax(case):
    shape = (2, 2)
    ja, jm, jc, jcam, jpx, jpy, jtarget = case["jax"]
    ta, tm, tc, cam, px, py, target = case["port"]
    jstep = jax_step(jax_mesh(jax.devices()[:4], shape=shape), jm, jc,
                     n_samples=2, lr=1.0)
    jp = jax_params(ja)
    jnew, jloss = jstep(jp, ja, jcam, jpx, jpy, jtarget,
                        jax.random.PRNGKey(0))
    step = make_sharded_train_step(LogicalMesh(shape), tm, tc, n_samples=2,
                                   lr=1.0)
    p = extract_params(ta)
    new, loss = step(p, ta, cam, px, py, target, threefry.prng_key(0))
    assert abs(float(loss) - float(jloss)) <= 1e-6 * float(jloss)
    for f in FIELDS:
        g = (getattr(p, f) - getattr(new, f)).numpy()     # lr = 1
        w = np.asarray(getattr(jp, f)) - np.asarray(getattr(jnew, f))
        assert np.abs(w).max() > 0
        assert np.abs(g - w).max() < GRAD_REL * np.abs(w).max(), f


def test_sharded_train_step_with_an_optimizer(case):
    # torch.optim in place of optax: SGD through the optimizer is the plain
    # update bit for bit, Adam descends, and every field the step trains
    # must belong to the optimizer
    ta, tm, tc, cam, px, py, target = case["port"]
    mesh = LogicalMesh((2, 2))

    def params():
        p = extract_params(ta)
        return p._replace(**{f: getattr(p, f).clone() for f in FIELDS},
                          tri_color=None, tex_planar=None, tex_sphere=None,
                          tex_cube=None)

    key = threefry.prng_key(0)
    plain = make_sharded_train_step(mesh, tm, tc, n_samples=2, lr=0.05)
    want, wloss = plain(params(), ta, cam, px, py, target, key)
    p = params()
    sgd = torch.optim.SGD([getattr(p, f) for f in FIELDS], lr=0.05)
    step = make_sharded_train_step(mesh, tm, tc, n_samples=2, optimizer=sgd)
    got, loss = step(p, ta, cam, px, py, target, key)
    assert got is p and float(loss) == float(wloss)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f))
    p = params()
    adam = torch.optim.Adam([getattr(p, f) for f in FIELDS], lr=0.05)
    step = make_sharded_train_step(mesh, tm, tc, n_samples=2, optimizer=adam)
    losses = [float(step(p, ta, cam, px, py, target, key)[1])
              for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    with pytest.raises(ValueError, match="tri_color"):
        step(p._replace(tri_color=ta.tri_color), ta, cam, px, py, target,
             key)
