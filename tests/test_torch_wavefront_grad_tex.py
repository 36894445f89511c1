"""pathtracer_tpu_torch's wavefront autograd path against the JAX
package's on the scenes that need more than `reference`
(tests/test_torch_wavefront_grad.py):

- `textures` at 16x12, 4 spp, PRNGKey(3), a black target: its walls are
  normal-mapped, so with the atlases trainable the rays themselves carry a
  gradient (a texel bends the next direction) and the kernel's route
  re-attaches every bounce's winner (intersect.reattach_hit). Every
  SceneParams field against jax.grad, the atlases included: each entry
  within 1e-3 x max|w| of its field (measured: the worst at 0.14 of that,
  tex_sphere; the JAX side's texels went through XLA:CPU's FMA
  contraction under jit, which moves textured pixels by up to 2.9e-5,
  tests/test_torch_wavefront_render.py). The JAX gradient holds NaN on 12
  texel entries (a grazing ray's unused refraction term: 0 x sqrt's
  infinite derivative at 0, render/sampling.py _sqrt0); the port's must be
  finite there.
- `teapot` at 32x24, 4 spp (at 16x12 no path through a triangle reaches
  the light): jax.grad cannot run here (reverse mode does not cross the
  JAX BVH walk's while_loop), so the port's tri_color gradient is held
  against the JAX package's forward-mode derivatives (jax.jvp): the
  partial derivative of every entry the port's gradient touches (one-hot
  tangents) and three random directions, each within 1e-7 + 1e-4 |w|
  (measured: the worst at 0.005 of that rule).

Both through the torch walk and through the kernel's route (its plain
version forced). Two JAX compiles (~22 s and ~10 s)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_wavefront_grad import (CPU, compare_grads, kernel_route,
                                   wavefront_pair)
from pathtracer_tpu.diff import extract_params as jax_extract
from pathtracer_tpu.diff import image_loss as jax_image_loss
from pathtracer_tpu.render.vec3 import Vec3 as JVec3
from pathtracer_tpu_torch.diff import extract_params, loss_and_grads
from pathtracer_tpu_torch.render import threefry
from pathtracer_tpu_torch.render.intersect import reattach_hit
from pathtracer_tpu_torch.render.vec3 import Vec3

torch.set_num_threads(2)

TEX_SCALE_REL = 1e-3
RTOL, ATOL = 1e-4, 1e-7
N_RANDOM = 3


@pytest.fixture(scope="module")
def textures():
    jax_side, port = wavefront_pair("textures", 16, 12, 4)
    ja, jm, jc, jcam, jpx, jpy = jax_side
    want = jax.jit(jax.grad(lambda p: jax_image_loss(
        p, ja, jm, jc, jcam, jpx, jpy, jax.random.PRNGKey(3), 4,
        JVec3.zeros((16 * 12,)))))(jax_extract(ja))
    return port, want


@pytest.mark.parametrize("route", ["walk", "kernel"])
def test_textures_grads_match_jax(textures, route):
    (ta, tm, tc, cam, px, py), want = textures
    r = kernel_route(ta, tm, tc) if route == "kernel" else None
    before = reattach_hit.calls
    _, got = loss_and_grads(extract_params(ta), ta, tm, tc, cam, px, py,
                            threefry.prng_key(3), 4,
                            Vec3.zeros((16 * 12,), torch.float32, CPU),
                            route=r)
    # the kernel's route re-attaches the rays that carry a gradient: every
    # bounce after the first (camera rays carry none)
    assert reattach_hit.calls - before == (
        tc.max_bounces - 1 if route == "kernel" else 0)
    out = compare_grads(got, want, scale_rel=TEX_SCALE_REL)
    assert out["tex_planar"][3] > 0        # the JAX NaN entries, finite here
    assert out["tex_planar"][2] > 0 and out["tex_sphere"][2] > 0


@pytest.fixture(scope="module")
def teapot():
    W, H, S = 32, 24, 4
    jax_side, port = wavefront_pair("teapot", W, H, S)
    ja, jm, jc, jcam, jpx, jpy = jax_side
    (ta, tm, tc, cam, px, py) = port
    _, g = loss_and_grads(extract_params(ta), ta, tm, tc, cam, px, py,
                          threefry.prng_key(3), S,
                          Vec3.zeros((W * H,), torch.float32, CPU))
    g = g.tri_color.numpy()
    touched = np.argwhere(g != 0)
    assert len(touched) >= 6
    tangents = np.zeros((len(touched) + N_RANDOM,) + g.shape, np.float32)
    for i, (s, c) in enumerate(touched):
        tangents[i, s, c] = 1.0
    tangents[len(touched):] = np.random.default_rng(0).standard_normal(
        (N_RANDOM,) + g.shape)
    p0 = jax_extract(ja)

    def f(tri_color):
        return jax_image_loss(p0._replace(tri_color=tri_color), ja, jm, jc,
                              jcam, jpx, jpy, jax.random.PRNGKey(3), S,
                              JVec3.zeros((W * H,)))
    jvp = jax.jit(jax.vmap(lambda v: jax.jvp(f, (p0.tri_color,), (v,))[1]))
    return port, S, W * H, tangents, np.asarray(jvp(jnp.asarray(tangents)))


@pytest.mark.parametrize("route", ["walk", "kernel"])
def test_teapot_tri_color_grads_match_jax_jvp(teapot, route):
    (ta, tm, tc, cam, px, py), S, P, tangents, want = teapot
    r = kernel_route(ta, tm, tc) if route == "kernel" else None
    _, got = loss_and_grads(extract_params(ta), ta, tm, tc, cam, px, py,
                            threefry.prng_key(3), S,
                            Vec3.zeros((P,), torch.float32, CPU), route=r)
    g = got.tri_color.double().numpy()
    dots = np.einsum("nsc,sc->n", tangents.astype(np.float64), g)
    d = np.abs(dots - want)
    ratio = d / (ATOL + RTOL * np.abs(want))
    print(f"tri_color: {len(want) - N_RANDOM} partials and {N_RANDOM} "
          f"directions, worst |g.v - jvp| {d.max():.3g} ({ratio.max():.3g} "
          f"of the rule)")
    assert np.isfinite(g).all() and (ratio <= 1.0).all(), ratio.max()
    assert np.abs(want[:-N_RANDOM]).min() > 0
