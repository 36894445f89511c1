"""The JAX twins of the parity tests do not depend on the JAX native scene
core (tests/_torch_parity.py jax_twin).

The JAX package parses .obj files and builds BVHs with its C++ library
when it loaded in the process (`pathtracer_tpu.native`, built by `make` on
first use; parallel test workers race for it, and PT_NATIVE=0 turns it
off), and on its NumPy path otherwise. The two paths differ (vertex
normals, the BVH, NaN group bounds on the NumPy path: ROADMAP §3), so a
twin built on whichever path loaded would make a parity test pass or fail
with the race. jax_twin builds on the NumPy path always: here the native
core is made to look loaded with every entry point raising, and the twin
must come out the same as with it off. No JAX compile.
"""
from unittest import mock

import numpy as np
import pytest

import pathtracer_tpu.native as jnative
from _torch_parity import jax_fields_np, jax_pack, jax_twin, scene_pair


def _unreachable(*args, **kwargs):
    raise AssertionError("the twin reached the JAX native scene core")


def _twin(name, native_loaded: bool):
    cfg = dict(width=16, height=12, samples=2)
    if not native_loaded:
        with mock.patch.object(jnative, "available", lambda: False):
            return jax_twin(name, **cfg)
    with mock.patch.object(jnative, "available", lambda: True), \
            mock.patch.object(jnative, "parse_obj", _unreachable), \
            mock.patch.object(jnative, "build_bvh", _unreachable):
        return jax_twin(name, **cfg)


@pytest.mark.parametrize("name", ["teapot", "cubemap", "glass"])
def test_jax_twin_ignores_the_native_core(name):
    on, off = _twin(name, True), _twin(name, False)
    a, b = jax_fields_np(on[2]), jax_fields_np(off[2])
    assert a.keys() == b.keys()
    for k in a:     # (NaN would differ: the group rows carry none)
        assert np.array_equal(a[k], b[k]), k
    assert on[3] == off[3]


def test_nan_group_rows_are_carried_by_the_rule():
    # the JAX NumPy path's `cubemap` group row is NaN (the model's empty
    # DefaultGroup); jax_twin replaces it by the port's row after holding
    # that row to the JAX package's box of the non-empty children
    with mock.patch.object(jnative, "available", lambda: False):
        js, _, ts, _ = scene_pair("cubemap", width=16, height=12)
        raw, meta = jax_pack(js, ts)
    groups = list(meta.group_indices)
    assert groups and np.isnan(np.asarray(raw.bb_min)[groups]).all()
    _, _, ja, _, ts, _ = _twin("cubemap", False)
    ta, _ = ts.pack(device="cpu")
    for j in groups:
        assert np.array_equal(np.asarray(ja.bb_min)[j], ta.bb_min[j].numpy())
        assert np.isfinite(ta.bb_min[j].numpy()).all()
