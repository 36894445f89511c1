"""pathtracer_tpu_torch's wavefront autograd path (diff.render_image_diff,
image_loss, train_step) against the JAX package's on `reference`, on
tests/test_grad.py's setup: 16x12, 4 spp, PRNGKey(3) with a black target
and PRNGKey(5) with a grey one. The threefry copy is bit-equal
(tests/test_torch_threefry.py), so both packages trace the same paths, and
the port's gradients of every SceneParams field are held against jax.grad
of the JAX image_loss entry by entry: |g - w| <= 1e-7 + 1e-4 |w|
(measured: the worst entry at 0.003 of that rule, emission). Both through
the torch walk and through the intersect kernel's route (its plain
version forced with integrator.intersect_route(..., fn=megakernel.
intersect_batch_reference)); on `reference` no ray carries a gradient, so
the route re-attaches nothing.

The finite-difference checks of tests/test_grad.py:31,58 run on the port
(central, eps 1e-2, relative 5e-2), and train_step lowers the loss (:79).
One JAX compile (~10 s) for the module. `textures` (normal maps, the
atlases) and `teapot` (triangle colors) are in
tests/test_torch_wavefront_grad_tex.py."""
import jax
import numpy as np
import pytest
import torch

from _torch_wavefront_grad import (CPU, compare_grads, kernel_route,
                                   wavefront_pair)
from pathtracer_tpu.diff import extract_params as jax_extract
from pathtracer_tpu.diff import image_loss as jax_image_loss
from pathtracer_tpu.render.vec3 import Vec3 as JVec3
from pathtracer_tpu_torch.diff import (SceneParams, extract_params,
                                       from_jax_params, image_loss,
                                       loss_and_grads, render_image_diff,
                                       train_step)
from pathtracer_tpu_torch.render import integrator, threefry
from pathtracer_tpu_torch.render.intersect import reattach_hit
from pathtracer_tpu_torch.render.vec3 import Vec3

torch.set_num_threads(2)

W, H, SPP = 16, 12, 4
RTOL, ATOL = 1e-4, 1e-7
# tests/test_grad.py's two (key, target) cases
CASES = {3: 0.0, 5: 0.5}


@pytest.fixture(scope="module")
def setup():
    jax_side, port = wavefront_pair("reference", W, H, SPP)
    ja, jm, jc, jcam, jpx, jpy = jax_side
    grad = jax.jit(jax.grad(lambda p, k, t: jax_image_loss(
        p, ja, jm, jc, jcam, jpx, jpy, k, SPP, t)))
    want = {}
    for seed, v in CASES.items():
        want[seed] = grad(jax_extract(ja), jax.random.PRNGKey(seed),
                          JVec3.full((W * H,), v, v, v))
    return port, want, ja


def _target(v):
    return Vec3.full((W * H,), v, v, v, torch.float32, CPU)


@pytest.mark.parametrize("seed", sorted(CASES))
@pytest.mark.parametrize("route", ["walk", "kernel"])
def test_grads_match_jax(setup, seed, route):
    (ta, tm, tc, cam, px, py), want, _ = setup
    r = kernel_route(ta, tm, tc) if route == "kernel" else None
    before = reattach_hit.calls
    loss, got = loss_and_grads(extract_params(ta), ta, tm, tc, cam, px, py,
                               threefry.prng_key(seed), SPP,
                               _target(CASES[seed]), route=r)
    assert reattach_hit.calls == before      # no ray carries a gradient
    assert got.tex is None
    out = compare_grads(got, want[seed], rtol=RTOL, atol=ATOL)
    # the light (object 0) emission has a gradient (test_grad.py:45)
    assert np.abs(got.emission[0].numpy()).max() > 0
    assert out["color"][2] > 0 and out["emission"][2] > 0


def _loss_fn(setup, seed, route):
    (ta, tm, tc, cam, px, py), _, _ = setup
    r = kernel_route(ta, tm, tc) if route == "kernel" else None

    def f(p):
        with torch.no_grad():
            return float(image_loss(p, ta, tm, tc, cam, px, py,
                                    threefry.prng_key(seed), SPP,
                                    _target(CASES[seed]), route=r))
    return f, extract_params(ta), r


@pytest.mark.parametrize("route", ["walk", "kernel"])
def test_emission_finite_difference(setup, route):
    # tests/test_grad.py:31: the light's red emission
    (ta, tm, tc, cam, px, py), _, _ = setup
    f, p, r = _loss_fn(setup, 3, route)
    _, g = loss_and_grads(p, ta, tm, tc, cam, px, py, threefry.prng_key(3),
                          SPP, _target(0.0), route=r)
    eps = 1e-2
    e = p.emission
    fd = (f(p._replace(emission=e.index_put(
        (torch.tensor(0), torch.tensor(0)), e[0, 0] + eps)))
        - f(p._replace(emission=e.index_put(
            (torch.tensor(0), torch.tensor(0)), e[0, 0] - eps)))) / (2 * eps)
    ad = float(g.emission[0, 0])
    assert np.isclose(ad, fd, rtol=5e-2, atol=1e-6), (ad, fd)


@pytest.mark.parametrize("route", ["walk", "kernel"])
def test_color_finite_difference(setup, route):
    # tests/test_grad.py:58: the floor's (object 1) red color
    (ta, tm, tc, cam, px, py), _, _ = setup
    f, p, r = _loss_fn(setup, 5, route)
    _, g = loss_and_grads(p, ta, tm, tc, cam, px, py, threefry.prng_key(5),
                          SPP, _target(0.5), route=r)
    eps = 1e-2
    c = p.color
    fd = (f(p._replace(color=c.index_put(
        (torch.tensor(1), torch.tensor(0)), c[1, 0] + eps)))
        - f(p._replace(color=c.index_put(
            (torch.tensor(1), torch.tensor(0)), c[1, 0] - eps)))) / (2 * eps)
    ad = float(g.color[1, 0])
    assert np.isclose(ad, fd, rtol=5e-2, atol=1e-6), (ad, fd)


def test_wavefront_train_step_descends(setup):
    # tests/test_grad.py:79: a black target, lr 0.1, keys folded per step
    (ta, tm, tc, cam, px, py), _, _ = setup
    key = threefry.prng_key(0)
    p, loss0 = train_step(extract_params(ta), ta, tm, tc, cam, px, py, key,
                          SPP, _target(0.0), lr=0.1)
    for i in range(4):
        p, loss = train_step(p, ta, tm, tc, cam, px, py,
                             threefry.fold_in(key, i + 10), SPP,
                             _target(0.0), lr=0.1)
    assert float(loss) < float(loss0)
    assert type(p) is SceneParams and p.tex is None
    assert not torch.equal(p.emission, ta.emission)


def test_render_image_diff_is_the_fixed_trip_render(setup):
    # the differentiable estimate is render_pass's sum over spp under the
    # fixed-trip loop and the float atlases: the forward image unchanged
    (ta, tm, tc, cam, px, py), _, _ = setup
    key = threefry.prng_key(3)
    img = render_image_diff(extract_params(ta), ta, tm, tc, cam, px, py,
                            key, SPP)
    ref = integrator.render_pass(ta, tm, tc, cam, px, py, 0, SPP, key)
    for a, b in zip(img, ref):
        assert torch.equal(a, b * (1.0 / SPP))


def test_from_jax_params_carries_the_atlases(setup):
    _, _, ja = setup
    p = from_jax_params({k: np.asarray(getattr(ja, k)) for k in (
        "color", "emission", "tri_color", "tex_planar", "tex_sphere",
        "tex_cube")}, CPU)
    for k in ("tex_planar", "tex_sphere", "tex_cube", "color"):
        assert np.array_equal(getattr(p, k).numpy(),
                              np.asarray(getattr(ja, k), np.float32))
    assert p.tex is None
    q = from_jax_params({k: np.asarray(getattr(ja, k)) for k in (
        "color", "emission", "tri_color")}, CPU)
    assert q.tex_planar is None and q.tex_cube is None


def test_kernel_route_takes_the_fixed_trip_loop(setup):
    (ta, tm, tc, *_), _, _ = setup
    cuda = torch.device("cuda")
    assert integrator.kernel_route_applies(
        tm, tc.replace(early_exit=False), cuda)
    assert not integrator.kernel_route_applies(
        tm, tc.replace(dtype="float64"), cuda)
    assert not integrator.kernel_route_applies(tm, tc, CPU)
    # on the CPU the differentiable render takes the torch walk
    assert integrator.intersect_route(ta, tm, tc).fn is None
