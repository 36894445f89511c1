"""The wavefront's random stream (pathtracer_tpu_torch.render.threefry)
against jax.random on the CPU: PRNGKey, fold_in, the 32-bit words and
uniform(float32) bit for bit, over several keys, data words and shapes,
and the chains of folds the integrator takes (chunk, pass, bounce,
light). No JAX compile beyond jax.random's own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.render import threefry

SEEDS = (0, 1, 7, 12345, 2 ** 31 - 1)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    key = threefry.prng_key(seed)
    assert key.dtype == torch.int64 and key.shape == (2,)
    assert np.array_equal(key.numpy(), _np(_jkey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax(seed):
    for data in (0, 1, 2, 3, 7, 255, 1000003, 1000003 + 119,
                 2 ** 31 - 1, 2 ** 32 - 1):
        got = threefry.fold_in(threefry.prng_key(seed), data)
        want = jax.random.fold_in(_jkey(seed), data)
        assert np.array_equal(got.numpy(), _np(want)), data


@pytest.mark.parametrize("shape", [(1,), (5,), (2, 7), (4, 33), (3, 1000),
                                   (2, 4097)])
def test_uniform_matches_jax_bit_for_bit(shape):
    for seed in SEEDS[:3]:
        k = threefry.fold_in(threefry.prng_key(seed), 5)
        got = threefry.uniform(k, shape).numpy()
        want = np.asarray(jax.random.uniform(
            jax.random.fold_in(_jkey(seed), 5), shape, dtype=jnp.float32))
        assert got.dtype == np.float32 and got.shape == shape
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        assert got.min() >= 0.0 and got.max() < 1.0


def test_random_bits_match_jax():
    k = threefry.prng_key(3)
    got = threefry.random_bits(k, (3, 65)).numpy()
    want = np.asarray(jax.random.bits(_jkey(3), (3, 65), jnp.uint32))
    assert np.array_equal(got, want.astype(np.int64))


def test_integrator_fold_chain_matches_jax():
    # driver segment -> row block -> chunk -> pass draws -> bounce -> NEE
    # light: the keys the wavefront derives, and the draws under them
    tk, jk = threefry.prng_key(11), _jkey(11)
    for data in (1000003 + 2, 5, 2, 3, 3, 1):
        tk, jk = threefry.fold_in(tk, data), jax.random.fold_in(jk, data)
        assert np.array_equal(tk.numpy(), _np(jk))
    got = threefry.uniform(tk, (4, 300)).numpy()
    want = np.asarray(jax.random.uniform(jk, (4, 300), dtype=jnp.float32))
    assert np.array_equal(got, want)


def test_uniform_on_a_device_argument():
    # the words are computed on the given device; the CPU here
    k = threefry.prng_key(9)
    got = threefry.uniform(k, (2, 10), torch.device("cpu"))
    assert got.device.type == "cpu"
    assert torch.equal(got, threefry.uniform(k, (2, 10)))
