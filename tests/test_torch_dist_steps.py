"""make_sharded_megakernel_step against the JAX package's on a 2-device
CPU mesh (interpret mode), on `reference`.

One process plays both ranks (parallel.mesh.LogicalMesh); the JAX step
runs shard_map over two virtual devices. Both draw each rank's samples
under (seed[0]*7919 + pix_rank*S + spp_rank + 1, seed[1] + spp_rank *
local_spp), so the gradients follow the same paths: held by the gradient
rule of tests/_torch_scenes.py (GRAD_REL of the largest entry), the loss
within 1e-6 relative, and the losses of two further steps, each side from
its own parameters, within 1e-5. Then a few steps toward a true-color
target descend.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_pack, scene_pair
from _torch_scenes import GRAD_REL
from pathtracer_tpu.diff.grad import make_sharded_megakernel_step as jax_step
from pathtracer_tpu.parallel import make_mesh as jax_mesh
from pathtracer_tpu_torch.diff import (make_megakernel_step,
                                       make_sharded_megakernel_step)
from pathtracer_tpu_torch.parallel.mesh import LogicalMesh

torch.set_num_threads(2)

W, H, SPP, TILE = 32, 24, 4, (8, 128)


@pytest.fixture(scope="module")
def pair():
    js, jc, ts, tc = scene_pair("reference", width=W, height=H, samples=SPP,
                                samples_per_pass=SPP)
    ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device=torch.device("cpu"))
    return js, jc, ja, jm, ts, tc, ta, tm


def test_sharded_megakernel_step_matches_jax(pair):
    js, jc, ja, jm, ts, tc, ta, tm = pair
    img = np.random.default_rng(3).random((H, W, 3)).astype(np.float32)
    mesh = jax_mesh(jax.devices()[:2], shape=(2, 1))
    jstep, jtarget_of = jax_step(ja, jm, jc, js.camera, mesh, spp=SPP,
                                 tile=TILE, lr=1.0, interpret=True)
    color = np.asarray(ja.color, np.float32)
    emission = np.asarray(ja.emission, np.float32)
    jc_, je_, jloss = jstep(jnp.asarray(color), jnp.asarray(emission),
                            jnp.asarray([5, 0], jnp.int32), jtarget_of(img))
    step, target_of = make_sharded_megakernel_step(
        ta, tm, tc, ts.camera, LogicalMesh((2, 1)), spp=SPP, tile=TILE,
        lr=1.0)
    tc_, te_, loss = step(ta.color, ta.emission, (5, 0), target_of(img))
    assert np.isfinite(float(loss))
    assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    for base, got, want in ((color, tc_, jc_), (emission, te_, je_)):
        g = base - got.numpy()          # lr = 1: the gradient
        w = base - np.asarray(want)
        assert np.abs(w).max() > 0
        assert np.abs(g - w).max() < GRAD_REL * np.abs(w).max()
    # two more steps, each from its own side's parameters: the two
    # descents take the same course, loss by loss, whether it falls or not
    jl, tl = [float(jloss)], [float(loss)]
    for _ in range(2):
        jc_, je_, jloss = jstep(jc_, je_, jnp.asarray([5, 0], jnp.int32),
                                jtarget_of(img))
        tc_, te_, loss = step(tc_, te_, (5, 0), target_of(img))
        jl.append(float(jloss))
        tl.append(float(loss))
    assert np.allclose(tl, jl, rtol=1e-5, atol=0), (tl, jl)


def test_sharded_step_is_the_single_step_on_one_rank(pair):
    # a 1x1 mesh: rank (0, 0) draws under seed[0]*7919 + 1, so the
    # unsharded step fed that seed takes the same samples
    *_, ts, tc, ta, tm = pair
    img = np.random.default_rng(4).random((H, W, 3)).astype(np.float32)
    step, target_of = make_sharded_megakernel_step(
        ta, tm, tc, ts.camera, LogicalMesh((1, 1)), spp=SPP, tile=TILE,
        lr=0.2)
    one, one_target_of = make_megakernel_step(ta, tm, tc, ts.camera,
                                              spp=SPP, tile=TILE, lr=0.2)
    a = step(ta.color, ta.emission, (5, 0), target_of(img))
    b = one(ta.color, ta.emission, (5 * 7919 + 1, 0), one_target_of(img))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_sharded_megakernel_step_descends(pair):
    *_, ts, tc, ta, tm = pair
    mesh = LogicalMesh((1, 2))
    step, target_of = make_sharded_megakernel_step(
        ta, tm, tc, ts.camera, mesh, spp=8, tile=TILE, lr=0.3)
    # the target: a render at the true colors (another seed)
    from pathtracer_tpu_torch.parallel.render_dist import \
        render_sharded_megakernel
    img = render_sharded_megakernel(ta, tm, ts.camera,
                                    tc.replace(samples=8, seed=11), mesh)
    target = target_of(img)
    c = ta.color.clone()
    c[1, 0] += 0.3
    c[6, 2] -= 0.2
    e = ta.emission
    losses = []
    for _ in range(4):
        c, e, loss = step(c, e, (7, 0), target)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses
