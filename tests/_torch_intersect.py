"""The intersect-only kernel's parity harness, shared by
tests/test_torch_intersect*.py: the JAX kernel wrapped in an interpret-mode
pallas_call, the rays, and the per-ray rule (stated in
tests/test_torch_intersect.py)."""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import pathtracer_tpu.native as jnative
from _torch_parity import jax_pack, scene_pair
from _torch_scenes import bounce_rays, camera_rays
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu_torch.render import megakernel as mk

TILE = (8, 128)
TIE_REL = 1e-4
ATOL, RTOL = 1e-5, 1e-4


def _jax_intersect(ja, jm, jc, rays):
    """The JAX intersect-only kernel in interpret mode over the flat rays
    (numpy f32 [R] x 6), padded as intersect_batch pads them."""
    S, L = TILE
    R = rays[0].shape[0]
    pad = (-R) % (S * L)
    fills = (1e6, 1e6, 1e6, 1.0, 0.0, 0.0)
    tiled = [jnp.pad(jnp.asarray(a), (0, pad), constant_values=f)
             .reshape(-1, L) for a, f in zip(rays, fills)]
    obj, nodes, tris = pk.scene_tables_jnp(ja, jm, traversal="classic")
    bspec = pl.BlockSpec((S, L), lambda i: (i, 0), memory_space=pltpu.VMEM)
    f32 = jax.ShapeDtypeStruct(tiled[0].shape, jnp.float32)
    i32 = jax.ShapeDtypeStruct(tiled[0].shape, jnp.int32)
    outs = pl.pallas_call(
        pk._make_intersect_kernel(jm, jc, TILE),
        grid=(tiled[0].shape[0] // S,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)] + [bspec] * 6,
        out_specs=[bspec] * 15,
        out_shape=[f32, i32] + [f32] * 13,
        interpret=True,
    )(obj, nodes, tris, *tiled)
    return [np.asarray(o).reshape(-1)[:R] for o in outs]


def _compare(got, want, ties):
    """Hold the port's intersect_batch result against the JAX outputs.
    Returns the share of rays whose winners agree."""
    t, idx, lo, ld, is_tri, nrm, col = (
        a.numpy() if isinstance(a, torch.Tensor) else
        np.stack([b.numpy() for b in a]) for a in got)
    jt, jidx = want[0], want[1]
    jloc = np.stack(want[2:8])
    jtri = want[8] > 0.5
    jnrm, jcol = np.stack(want[9:12]), np.stack(want[12:15])
    same = (idx == jidx) & (is_tri == jtri)
    # a winner may differ only at a tie
    assert (same | ties).all(), np.nonzero(~(same | ties))[0][:10]
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(t[same], jt[same], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np.concatenate([lo, ld])[:, same],
                               jloc[:, same], atol=ATOL, rtol=RTOL)
    on = same & is_tri
    np.testing.assert_allclose(nrm[:, on], jnrm[:, on], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(col[:, on], jcol[:, on], atol=ATOL, rtol=RTOL)
    assert not nrm[:, ~is_tri].any() and not col[:, ~is_tri].any()
    return float(same.mean())




def intersect_parity(name):
    """Hold intersect_batch's plain version against the JAX kernel on scene
    `name` (camera rays, misses, one bounce), by the rule of
    tests/test_torch_intersect.py. Returns the share of rays whose winners
    agree, per batch."""
    with mock.patch.object(jnative, "available", lambda: False):
        js, jc, ts, tc = scene_pair(name, width=16, height=12, samples=1)
        ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device="cpu")
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert mk.supports_intersect(tm) and pk.supports_intersect(jm)
    tables = mk.intersect_tables(ta, tm, "cpu")
    if tm.has_groups:
        # the JAX NumPy path packs NaN group bounds for a parsed model
        # (ROADMAP queue 3): hand it the port's
        ja = ja._replace(bb_min=jnp.asarray(ta.bb_min.numpy()),
                         bb_max=jnp.asarray(ta.bb_max.numpy()))
    jobj = np.asarray(pk.scene_tables_jnp(ja, jm, traversal="classic")[0])
    assert np.array_equal(jobj, tables[0].numpy())
    gen = torch.Generator()
    gen.manual_seed(0)
    o, d = camera_rays(ts.camera, 16, 12, 4, gen)
    # and rays that start outside the scene and leave it: mostly misses
    # (the walls are infinite planes)
    out = torch.randn((3, 256), generator=gen)
    out = out / torch.linalg.vector_norm(out, dim=0)
    o = tuple(torch.cat([a, 20 * b]) for a, b in zip(o, out))
    d = tuple(torch.cat([a, b]) for a, b in zip(d, out))
    first = mk.intersect_batch(ta, tm, tc, o, d, tables=tables)
    shares = []
    for batch in ((o, d), bounce_rays(o, d, first[0], tc.t_max, gen)):
        before = mk.intersect_batch.launches
        got = mk.intersect_batch(ta, tm, tc, *batch, tables=tables)
        assert mk.intersect_batch.launches == before  # CPU never launches
        rays = [a.numpy() for a in (*batch[0], *batch[1])]
        want = _jax_intersect(ja, jm, jc, rays)
        ties = _tie_mask(tm, tc, tables, (*batch[0], *batch[1]))
        shares.append(_compare(got, want, ties))
    # a miss: t_max, winner 0, the world ray
    miss = first[0].numpy() == tc.t_max
    assert miss[-256:].mean() > 0.5 and not miss[:-256].any()
    assert not first[1].numpy()[miss].any()
    for k in range(3):
        assert torch.equal(first[2][k][miss], o[k][miss])
        assert torch.equal(first[3][k][miss], d[k][miss])
    if tm.has_groups:
        assert first[4].any()                    # triangles won
    return shares


def _tie_mask(tm, tc, tables, rays):
    """Rays whose nearest and second-nearest objects' t lie within TIE_REL
    of each other (each object's t from the plain nearest hit over that
    object alone)."""
    obj = tables[0].numpy().tolist()
    ts = []
    for j in range(tm.n_objects):
        meta = dataclasses.replace(
            tm, obj_types=(tm.obj_types[j],),
            group_indices=(0,) if j in tm.group_indices else (),
            group_bvh=tuple((0, r, e) for g, r, e in tm.group_bvh if g == j))
        t, *_ = mk._nearest_hit([obj[j]], meta, *tables[1:],
                                tc.epsilon, tc.t_max, *rays,
                                torch.ones_like(rays[0], dtype=torch.bool),
                                0)
        ts.append(t.numpy())
    ts = np.sort(np.stack(ts), axis=0)
    return (ts[1] - ts[0]) <= TIE_REL * np.abs(ts[0])
