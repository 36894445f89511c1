"""pathtracer_tpu_torch kernel PRNG and ray-primitive functions against the
JAX package's: the counter hash must be bit-equal to the interpret-mode
software stream, and the primitive functions compute the same f32
formulas (tolerance rtol=atol=1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu_torch.render import megakernel as mk

torch.set_num_threads(2)

EPS = 1e-4


@pytest.mark.parametrize("shape", [(8, 128), (64, 256)])
@pytest.mark.parametrize("seed,tile,did,n,b", [
    (0, 0, 0, 0, None),
    (1, 3, 1, 7, None),
    (7919 * 5 + 17, 74, 2, 127, 0),
    (123456789, 11, 5, 3, 9),
    (2 ** 31 - 1, 2 ** 20, 4, 2 ** 16 + 1, 2 ** 10),
])
def test_uniform_bit_equal_jax(monkeypatch, shape, seed, tile, did, n, b):
    monkeypatch.setattr(pk, "_SW_PRNG", True)
    pk._prng_seed(jnp.int32(seed), jnp.int32(tile))
    jn = jnp.int32(n)
    jb = None if b is None else jnp.int32(b)
    key = mk._prng_key(seed, tile)
    for jfn, tfn in ((pk._uniform, mk._uniform),
                     (pk._uniform_row, mk._uniform_row)):
        want = np.asarray(jfn(shape, did, jn, jb))
        got = tfn(key, shape, did, n, b).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(got, want)
    assert (got >= 0).all() and (got < 1).all()


def _rays(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.0, 2.0, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    # a few axis-parallel directions exercise the slab's |d| < eps branch
    d[0, :64] = 0.0
    d[1, 64:128] = 0.0
    return o, d


def _both(fn_name, *args):
    jfn = getattr(pk, fn_name)
    tfn = getattr(mk, fn_name)
    ja = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    ta = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in args]
    want = jfn(*ja)
    got = tfn(*ta)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    return ([np.asarray(w) for w in want], [g.numpy() for g in got])


@pytest.mark.parametrize("fn_name", ["_plane_t", "_sphere_t", "_cylinder_t",
                                     "_box_t", "_axis_slab"])
def test_intersections_match_jax(fn_name):
    o, d = _rays()
    args = {
        "_plane_t": (o[1], d[1], EPS),
        "_sphere_t": (*o, *d, EPS),
        "_cylinder_t": (*o, *d, -0.5, 0.7, EPS),
        "_box_t": (*o, *d, EPS),
        "_axis_slab": (o[0], d[0], -1.0, 1.0, EPS),
    }[fn_name]
    want, got = _both(fn_name, *args)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    # the rays must actually hit something for the test to mean anything
    assert (want[0] < 1e29).mean() > 0.1


@pytest.mark.parametrize("fn_name", ["_schlick", "_refract"])
@pytest.mark.parametrize("entering", [True, False])
def test_fresnel_and_refraction_match_jax(fn_name, entering):
    rng = np.random.default_rng(1)
    c = rng.normal(size=(3, 4096))
    c = (c / np.linalg.norm(c, axis=0)).astype(np.float32)
    nrm = rng.normal(size=(3, 4096))
    nrm = (nrm / np.linalg.norm(nrm, axis=0)).astype(np.float32)
    ior = rng.uniform(1.0, 2.0, 4096).astype(np.float32)
    one = np.ones(4096, np.float32)
    n1, n2 = (one, ior) if entering else (ior, one)
    want, got = _both(fn_name, *c, *nrm, n1, n2)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
