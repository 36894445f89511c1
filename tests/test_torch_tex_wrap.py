"""K1-tex's REPEAT wrap without a division (csrc/megakernel.cu wrap_fast,
texel_taps; the plain versions render/megakernel.py wrap_fast,
wrap_is_fast, texel_taps) held on the CPU to the JAX kernel's formula
a - m floor(a / m) (pallas_kernel._wrap_tex): over integers around the
fast branch's bounds (|a| < 2^22, m <= 2^23) and past them, for every
texture side of the textured scenes and awkward ones, and through the
fetch (sample_pool, texel_taps) on seeded UVs with integer edges,
negative coordinates, anchors at 2^22 - 1, 2^23, 2^24 and beyond, +-inf,
NaN and the pool's last texel, bit for bit. No JAX kernel is compiled:
the renders are held to the JAX kernel by tests/test_torch_tex_kernel.py,
whose plain version fetches through the same texel_taps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_scene
from _torch_scenes import TEX_SCENES
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu_torch.render import megakernel as mk

torch.set_num_threads(2)

CPU = torch.device("cpu")
SCENES = TEX_SCENES + ("textures-train", "envmap-file")
# integers around the fast wrap's bound (2^22 for |a|) and the f32 ones
EDGES = [0, 2 ** 22, 2 ** 23, 2 ** 24, 2 ** 25]


def _sides(name):
    """The widths and heights of the textures scene `name` samples."""
    ts, _ = port_scene(name, width=8, height=6)
    table = mk.build_tex_table(*ts.pack(device=CPU))
    return sorted({int(x) for col in (0, 6) for x in
                   table[table[:, col] > 0.5][:, col + 2:col + 4].ravel()})


def _edge_integers(rng):
    """f32 integers around EDGES, both signs, and random ones up to 2^26."""
    near = np.arange(-300, 301)
    a = np.concatenate([e * s + near for e in EDGES for s in (1, -1)]
                       + [rng.integers(-2 ** 26, 2 ** 26, 4096)])
    return a.astype(np.float32)


@pytest.mark.parametrize("name", SCENES)
def test_fetch_wrap_equals_jax_kernel_wrap(name):
    a = _edge_integers(np.random.default_rng(3))
    for m in _sides(name):
        with jax.disable_jit():
            want0 = np.asarray(pk._wrap_tex(jnp.asarray(a), m))
            want1 = np.asarray(pk._wrap_tex(jnp.asarray(a) + 1.0, m))
        x = torch.from_numpy(a)
        fm = torch.full_like(x, float(m))
        fast = mk.wrap_is_fast(x, x, fm, fm)
        c0 = mk.wrap_fast(x, fm, torch.ones_like(fm) / fm)
        c1 = torch.where(c0 + 1.0 == fm, 0.0, c0 + 1.0)
        assert 2 * 300 + 601 < int(fast.sum()) < a.size
        assert np.array_equal(c0[fast].numpy(), want0[fast.numpy()])
        assert np.array_equal(c1[fast].numpy(), want1[fast.numpy()])


@pytest.mark.parametrize("m", [1, 2, 3, 7, 96, 128, 256, 512, 768, 1024,
                               2048, 2 ** 23, 2 ** 23 + 1])
def test_wrap_fast_is_the_formula(m):
    fast_total = 0
    for e in EDGES:
        for lo in (e - 300, -e - 300):
            fast, bad = mk.wrap_check(m, lo, lo + 600, CPU)
            assert bad == 0, (m, lo)
            fast_total += fast
    if m > 2 ** 23:
        assert fast_total == 0       # past kSideFast: the formula alone
    else:
        # every integer of [-300, 300] twice (e = 0), and those below 2^22
        # in magnitude around +-2^22
        assert fast_total == 2 * 601 + 2 * 300


def test_wrap_fast_values():
    a = torch.tensor([-5.0, -4.0, -1.0, -0.0, 0.0, 3.0, 4.0, 9.0,
                      -(2.0 ** 22 - 1), 2.0 ** 22 - 1], dtype=torch.float32)
    m = torch.full_like(a, 4.0)
    got = mk.wrap_fast(a, m, torch.ones_like(m) / m)
    assert got.tolist() == [3.0, 0.0, 3.0, 0.0, 0.0, 3.0, 0.0, 1.0, 1.0,
                            3.0]
    assert torch.equal(got, mk._wrap_tex(a, m))
    x = torch.tensor([0.0, 2.0 ** 22 - 1, 2.0 ** 22, float("nan"),
                      float("inf"), -float("inf")])
    one = torch.ones_like(x)
    assert mk.wrap_is_fast(x, 0 * one, one, one).tolist() == [
        True, True, False, False, False, False]
    assert mk.wrap_is_fast(0 * one, x, one, one).tolist() == [
        True, True, False, False, False, False]
    assert not bool(mk.wrap_is_fast(one, one, 2.0 ** 23 + one, one).any())


def _pool_and_textures(rng):
    """A random rgb8 pool of textures of awkward sides (a 1-texel row and
    column among them), the last one ending at the pool's last texel."""
    sides = [(16, 8), (5, 3), (1, 7), (4, 1), (1, 1), (9, 13)]
    textures, off = [], 0
    for w, h in sides:
        textures.append((off, w, h))
        off += w * h
    pool = rng.integers(0, 1 << 24, off).astype(np.int32)
    return torch.from_numpy(pool), textures


def _uvs(rng, w, h, n=512):
    """Seeded UVs whose anchors x0 = floor(u w - 0.5) cover the edges:
    integer texel centres (tx = 0), negative coordinates, |x0| near 2^22,
    2^23, 2^24 and beyond, +-inf and NaN."""
    big = np.array([2.0 ** 22 - 1, 2.0 ** 22, 2.0 ** 23 - 1, 2.0 ** 23,
                    2.0 ** 24, 2.0 ** 25, 3e9, 1e30])
    cols = [rng.uniform(-3.0, 4.0, n),
            (rng.integers(-40, 40, n) + 0.5) / w,
            np.concatenate([big, -big]) / w,
            (np.concatenate([big, -big]) + 0.5) / w,
            np.array([np.inf, -np.inf, np.nan, 0.0, 1.0, -1.0,
                      1.0 - 1e-7, 1.0 / w, (w - 0.5) / w])]
    u = np.concatenate(cols).astype(np.float32)
    v = rng.permutation(np.concatenate(
        [c * w / h for c in cols])).astype(np.float32)
    return torch.from_numpy(u), torch.from_numpy(v)


def test_fetch_with_the_fast_wrap_equals_the_jax_wrap():
    rng = np.random.default_rng(10)
    pool, textures = _pool_and_textures(rng)
    fast_lanes = cold_lanes = 0
    for base, w, h in textures:
        u, v = _uvs(rng, w, h)
        f = lambda x: torch.full_like(u, float(x))  # noqa: E731
        args = (f(base), f(w), f(h), u, v)
        got_idx, _, _ = mk.texel_taps(*args)
        want_idx, _, _ = mk.texel_taps(*args, fast=False)
        for g, t in zip(got_idx, want_idx):
            assert torch.equal(g, t)
        want = mk.sample_pool(pool, *args, fast=False)
        for fetch in (mk.sample_pool(pool, *args),
                      mk.fetch_texels(pool, base, w, h, u, v),
                      mk.fetch_texels(pool, base, w, h, u, v, fast=False)):
            for g, t in zip(fetch, want):
                assert torch.equal(g.isnan(), t.isnan())
                assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(t))
        fast = mk.wrap_is_fast(torch.floor(u * w - 0.5),
                               torch.floor(v * h - 0.5), f(w), f(h))
        fast_lanes += int(fast.sum())
        cold_lanes += int((~fast).sum())
    assert fast_lanes > 2000 and cold_lanes > 100


def test_taps_at_the_pool_last_texel():
    # anchors on the last texture's last row and column wrap to its first
    # (the pool's first texels are another texture's)
    pool, textures = _pool_and_textures(np.random.default_rng(11))
    base, w, h = textures[-1]
    assert base + w * h == pool.numel()
    u = torch.tensor([(w - 1 + 0.75) / w])
    v = torch.tensor([(h - 1 + 0.75) / h])
    f = lambda x: torch.full_like(u, float(x))  # noqa: E731
    idx, tx, ty = mk.texel_taps(f(base), f(w), f(h), u, v)
    assert [int(i) for i in idx] == [base + w * h - 1, base + (h - 1) * w,
                                     base + w - 1, base]
    assert 0.2 < float(tx) < 0.3 and 0.2 < float(ty) < 0.3


def test_fetch_refuses_bad_arguments():
    pool = torch.zeros(64, dtype=torch.int32)
    u = torch.zeros(4)
    with pytest.raises(ValueError, match="inside the pool"):
        mk.fetch_texels(pool, 60, 4, 4, u, u)
    with pytest.raises(ValueError, match="pool must be"):
        mk.fetch_texels(pool.reshape(16, 4), 0, 2, 2, u, u)
    with pytest.raises(ValueError, match="side"):
        mk.wrap_check(0, 0, 10, CPU)
