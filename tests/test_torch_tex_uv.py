"""pathtracer_tpu_torch's UV maps and texel fetch against the JAX
megakernel's (pallas_kernel._spherical_uv, _cube_uv, _sample_proc) on the
CPU, at random points and at UVs in [-2, 3] (the REPEAT wrap).

Bit equality is held op by op (jax.disable_jit): under jit, XLA:CPU fuses
the elementwise ops and contracts a*b + c into fused multiply-adds (on
this CPU 17% of a*b + c*d differ from the two-rounding result), which the
port, the plain NumPy texel pool and the CUDA kernel (-fmad=false) do not
do. The jitted JAX functions are held to bounds instead. One more
difference is PyTorch's: its CPU sqrt is not correctly rounded on a small
share of inputs, which moves the sphere map's v (an acos through sqrt) by
at most a few ulps; on the card the plain version's sqrt is IEEE and the
kernel equals it bit for bit (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu.render import proctex as jpt
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.render import proctex as tpt
from pathtracer_tpu_torch.scene import pack as tpack

torch.set_num_threads(2)

N = 1 << 15
RNG = np.random.default_rng(7)
_D = RNG.normal(size=(N, 3)).astype(np.float32)
SPHERE_PTS = (_D / np.linalg.norm(_D, axis=1, keepdims=True)).astype(
    np.float32)
CUBE_PTS = (_D / np.abs(_D).max(axis=1, keepdims=True)).astype(np.float32)
CUBE_PTS[:256] = np.round(CUBE_PTS[:256])      # edges and corners
UV = RNG.uniform(-2.0, 3.0, (2, N)).astype(np.float32)
# the texture of each program (the scenes' parameters, small sizes)
TEXTURES = {
    "checker": ((8, (0.9, 0.9, 0.9), (0.2, 0.2, 0.2)), 48, 64),
    "squares": ((7,), 128, 128),
    "squares_nm": ((), 128, 128),
    "cobblestone": ((11, 13), 256, 96),
    "floorboards": ((17,), 128, 128),
    "planet": ((23,), 128, 256),
    "jupiter": ((31,), 128, 256),
    "sky": ((), 64, 128),
    "cube_cross": ((16,), 48, 64),
}


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _uv_pair(jax_fn, port_fn, pts, jit):
    xs = [np.ascontiguousarray(pts[:, k]) for k in range(3)]
    if jit:
        want = jax.jit(jax_fn)(*map(jnp.asarray, xs))
    else:
        with jax.disable_jit():
            want = jax_fn(*map(jnp.asarray, xs))
    got = port_fn(*map(torch.from_numpy, xs))
    return ([g.numpy() for g in got], [np.asarray(w) for w in want])


def test_cube_uv_bit_equal_jax():
    got, want = _uv_pair(pk._cube_uv, mk._cube_uv, CUBE_PTS, jit=False)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_spherical_uv_equal_jax():
    (gu, gv), (wu, wv) = _uv_pair(pk._spherical_uv, mk._spherical_uv,
                                  SPHERE_PTS, jit=False)
    assert np.array_equal(gu, wu)
    # v = acos(y) / pi: PyTorch's CPU sqrt (see the module docstring)
    assert (gv == wv).mean() > 0.99 and _ulps(gv, wv).max() <= 4


@pytest.mark.parametrize("name,fn", [("sphere", "_spherical_uv"),
                                     ("cube", "_cube_uv")])
def test_uv_maps_near_jitted_jax(name, fn):
    # under jit the JAX polynomial and blends contract into FMAs
    pts = SPHERE_PTS if name == "sphere" else CUBE_PTS
    got, want = _uv_pair(getattr(pk, fn), getattr(mk, fn), pts, jit=True)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() < 1e-5


def _pool_of(name):
    params, h, w = TEXTURES[name]
    img = tpt.make((name, params), h, w)
    # behind another texture, so the base offset is nonzero
    pool, tabs = tpack._build_texel_pool(
        {"planar": [np.full((3, 7, 3), 0.5, np.float32), img]})
    (base, tw, th) = tabs["planar"][1]
    assert (tw, th) == (w, h)
    return torch.from_numpy(pool.view(np.int32)), base, (name, params), w, h


@pytest.mark.parametrize("name", sorted(TEXTURES))
def test_sample_pool_bit_equal_sample_proc(name):
    # the pool's 4-tap fetch against the JAX kernel's computed texels,
    # op by op; `jupiter` runs a sin, whose jnp and NumPy results may differ
    # before the rgb8 rounding (one texel step, 1/255, at most), though
    # none does at these points
    pool, base, desc, w, h = _pool_of(name)
    u, v = (torch.from_numpy(a) for a in UV)
    got = mk.fetch_texels(pool, base, w, h, u, v)
    with jax.disable_jit():
        want = pk._sample_proc(desc, w, h, jnp.asarray(UV[0]),
                               jnp.asarray(UV[1]))
    for g, wt in zip(got, want):
        g, wt = g.numpy(), np.asarray(wt)
        if name == "jupiter":
            assert np.abs(g - wt).max() <= np.float32(1 / 255) * 1.01
        else:
            assert np.array_equal(g, wt)


@pytest.mark.parametrize("name", ["cube_cross", "planet", "jupiter"])
def test_sample_pool_near_jitted_sample_proc(name):
    # under jit a texel's pre-rounding value may move by an ulp across a
    # rgb8 rounding edge: one texel step at most
    pool, base, desc, w, h = _pool_of(name)
    u, v = (torch.from_numpy(a) for a in UV)
    got = mk.fetch_texels(pool, base, w, h, u, v)
    want = jax.jit(lambda a, b: pk._sample_proc(desc, w, h, a, b))(
        *map(jnp.asarray, UV))
    for g, wt in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(wt)).max() <= np.float32(
            1 / 255) * 1.01


def test_pool_texels_equal_jax_quantized_texels():
    # every texel of the pool decodes to the JAX kernel's eval_texel
    for name, (params, h, w) in TEXTURES.items():
        pool, base, desc, _, _ = _pool_of(name)
        q = pool[base:base + w * h].numpy().reshape(h, w)
        iy, ix = np.mgrid[0:h, 0:w].astype(np.float32)
        want = jpt.eval_texel(np, desc, ix, iy, h, w)
        for k, c in enumerate(want):
            dec = ((q >> (8 * k)) & 255).astype(np.float32) * np.float32(
                1.0 / 255.0)
            assert np.array_equal(dec, np.broadcast_to(c, (h, w))), name


def test_fetch_texels_checks_its_texture():
    pool, base, _, w, h = _pool_of("sky")
    u = torch.zeros(4)
    with pytest.raises(ValueError, match="not inside the pool"):
        mk.fetch_texels(pool, base, w + 1, h, u, u)
    with pytest.raises(ValueError, match="u must be"):
        mk.fetch_texels(pool, base, w, h, u.double(), u)
