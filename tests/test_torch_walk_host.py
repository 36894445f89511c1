"""The host side of pathtracer_tpu_torch's mesh-walk variants against the JAX
package: the MXU blocks (bit for bit against pallas_kernel._mxu_plane_arrays
and, lane-packed by the JAX package's own _mxu_pack, its
build_mxu_tri_table), their fragment layout in the triangle table, the knobs'
walks and the kernel's groups; and the probes' op counts and plain runs
(`--device cpu`).

The JAX side is packed with the native scene-core library off (its NumPy
path, which the port follows; tests/test_torch_mesh_host.py)."""
import json
from unittest import mock

import numpy as np
import pytest
import torch

import pathtracer_tpu.native as jnative
from _torch_parity import jax_pack, scene_pair
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu_torch.probes import leaf_bench, op_rate
from pathtracer_tpu_torch.render import megakernel as mk

torch.set_num_threads(2)

CPU = torch.device("cpu")
CFG = dict(width=16, height=12, samples=1, samples_per_pass=1)


def _pair(name, monkeypatch, leaf=None):
    if leaf is not None:
        monkeypatch.setenv("PT_BVH_LEAF", str(leaf))
    with mock.patch.object(jnative, "available", lambda: False):
        js, _, ts, _ = scene_pair(name, **CFG)
        ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device=CPU)
    return ja, jm, ta, tm


def _f32(a):
    return np.asarray(a, dtype=np.float32)


@pytest.mark.parametrize("name,leaf", [("teapot", None), ("glass", None),
                                       ("teapot", 16), ("teapot", 12),
                                       ("default", 8)])
def test_mxu_blocks_bit_equal_jax(monkeypatch, name, leaf):
    ja, jm, ta, tm = _pair(name, monkeypatch, leaf)
    K = tm.leaf_size
    a, pay = mk.mxu_plane_arrays(ta, tm)
    want_a, want_pay = pk._mxu_plane_arrays(
        np, *(_f32(getattr(ja, f)) for f in (
            "tri_p1", "tri_e1", "tri_e2", "tri_n1", "tri_n2", "tri_n3",
            "tri_color")), K)
    assert a.dtype == np.float32 and np.array_equal(a, want_a)
    assert pay.dtype == np.float32 and np.array_equal(pay, want_pay)
    # lane-packed by the JAX package's own packing: its MXU table
    assert np.array_equal(pk._mxu_pack(np, a, pay, K),
                          pk.build_mxu_tri_table(ja, jm))
    # the payload is the shading table's (n1, n2-n1, n3-n1, color)
    shade = mk.build_mesh_tables(ta, tm, "classic")[2]
    got = pay[:, :12].transpose(0, 2, 1).reshape(-1, 12)
    assert np.array_equal(got, shade)


@pytest.mark.parametrize("leaf", [None, 12])
def test_mxu_fragments_in_the_triangle_table(monkeypatch, leaf):
    # the kernel's A fragments: [leaf, group, 8-row tile, lane] = a[leaf,
    # g*K + 8*kt + lane//4, 4*h + lane%4], zero past K rows and in the half
    # of q the group does not read; after the classic rows under mxu
    ja, jm, ta, tm = _pair("teapot", monkeypatch, leaf)
    K = tm.leaf_size
    a, _ = mk.mxu_plane_arrays(ta, tm)
    frag = mk.mxu_fragments(a)
    nkt = -(-K // 8)
    assert frag.shape == (tm.n_tri_slots // K, 6, nkt, 32)
    for g, h in enumerate(mk._MXU_D_HALF):
        assert not a[:, g * K:(g + 1) * K, 4 * (1 - h):4 * (2 - h)].any()
        for kt in range(nkt):
            for lane in range(32):
                r = 8 * kt + lane // 4
                want = a[:, g * K + r, 4 * h + lane % 4] if r < K else 0.0
                assert (frag[:, g, kt, lane] == want).all()
    classic = mk.build_mesh_tables(ta, tm, "classic")[1]
    monkeypatch.setenv("PT_TRAVERSAL", "mxu")
    nodes, tris, shade = mk.build_mesh_tables(ta, tm)
    assert tris.shape == mk._table_shapes(tm, mk.scene_walk(tm))[2]
    assert np.array_equal(tris[:classic.shape[0]], classic)
    view = mk.mxu_view(torch.from_numpy(tris), tm).numpy()
    assert np.array_equal(view, frag.reshape(*frag.shape[:2], nkt * 8, 4))


@pytest.mark.parametrize("env,walk", [
    ({}, ("thread", "simt")),
    ({"PT_SUBPACKET": "1"}, ("block", "simt")),
    ({"PT_SUBPACKET": "2"}, ("block", "simt")),
    ({"PT_SUBPACKET": "3"}, ("warp", "simt")),
    ({"PT_TRAVERSAL": "mxu"}, ("block", "mma")),
    ({"PT_TRAVERSAL": "mxu", "PT_SUBPACKET": "3"}, ("block", "mma")),
    ({"PT_TRAVERSAL": "mxu", "PT_ABLATE_LEAF": "1"}, ("block", "mma")),
    ({"PT_ABLATE_LEAF": "1"}, ("thread", "none")),
    ({"PT_SUBPACKET": "2", "PT_ABLATE_LEAF": "1"}, ("block", "none")),
    ({"PT_SUBPACKET": "3", "PT_ABLATE_LEAF": "1"}, ("warp", "none")),
])
def test_knobs_select_the_walks(monkeypatch, env, walk):
    # the JAX package's choices: mxu wins over PT_SUBPACKET and has no
    # ablation (pallas_kernel.py:1992-2014, :1395-1397)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert mk.mesh_walk() == mk.Walk(*walk)
    octant, packet = mk.walk_groups(300, mk.mesh_walk())
    if walk[0] == "thread":
        assert octant is None and packet is None
    else:
        assert torch.equal(packet, torch.arange(300) // 32)
        size = 128 if walk[0] == "block" else 32
        assert torch.equal(octant, torch.arange(300) // size)


@pytest.mark.parametrize("env,match", [
    ({"PT_SUBPACKET": "2"}, "item 17"), ({"PT_SUBPACKET": "3"}, "item 17"),
    ({"PT_ABLATE_LEAF": "1"}, "item 17"),
    ({"PT_TRAVERSAL": "mxu"}, "classic-traversal only")])
def test_gradient_kernel_refuses_the_walk_knobs(monkeypatch, env, match):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match=match):
        mk._check_mesh_knobs()


def test_group_octant_is_the_majority_of_the_active_rays():
    # _group_octant_base: per axis strictly more than half negative
    d = torch.tensor([[-1., 1, 1], [-1, -1, 1], [1, -1, 1], [1, 1, -1],
                      [-1, -1, -1], [-1, 1, 1]])
    group = torch.tensor([0, 0, 0, 0, 1, 1])
    oct_ = mk._group_octant(group, d[:, 0], d[:, 1], d[:, 2])
    # group 0: x 2/4 (not > half), y 2/4, z 1/4 -> 0; group 1: x 2/2,
    # y 1/2, z 1/2 -> 1
    assert oct_.tolist() == [0, 0, 0, 0, 1, 1]


def test_op_rate_counts_and_plain_runs(capsys):
    assert op_rate.OPS_PER_ITER["leafmix"] == 35 * 32 + 7
    assert op_rate.OPS_PER_ITER["cmp_sel"] == 64
    assert all(op_rate.OPS_PER_ITER[v] == 32 for v in op_rate.VARIANTS
               if v not in ("leafmix", "cmp_sel"))
    assert op_rate.main(["--device", "cpu", "--threads", "256",
                         "mul_par8", "leafmix", "sincos"]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["variant"] for r in rows] == ["mul_par8", "leafmix", "sincos"]
    for r in rows:
        assert r["device"] == "cpu" and r["ops_per_s"] > 0
        assert r["ops"] == 256 * 2 * op_rate.OPS_PER_ITER[r["variant"]]
    # the plain chains: one multiply chain x 1.000001 per op, exactly
    x = torch.full((4,), 1.5)
    out = op_rate.run("mul_par8", x, 1)
    c = [np.float32(1.5) + np.float32(0.01) * np.float32(j)
         for j in range(8)]
    for k in range(32):
        c[k & 7] = np.float32(c[k & 7] * np.float32(1.000001))
    s = np.float32(0.0)
    for j in range(8):
        s = np.float32(s + c[j])
    assert np.array_equal(out.numpy(), np.full(4, s, np.float32))
    with pytest.raises(ValueError, match="variant"):
        op_rate.run("fma_tree", x, 1)


@pytest.mark.parametrize("variant", op_rate.EXACT)
def test_op_rate_skipped_operation_shows(monkeypatch, variant):
    # op_rate.compare holds these variants bit for bit: a kernel that skips
    # one operation (here the body's last) differs on every thread
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        1.0, 2.0, 4096).astype(np.float32))
    full = op_rate.run_plain(variant, x, 1)
    assert op_rate.compare(variant, full, full)["ok"]
    # cmp_sel works on the even positions only
    monkeypatch.setattr(op_rate, "UNROLL", 30 if variant == "cmp_sel" else 31)
    short = op_rate.run_plain(variant, x, 1)
    assert not op_rate.compare(variant, short, full)["ok"]
    assert (short != full).all()


def test_leaf_bench_plain_runs(capsys):
    assert leaf_bench.main(["--device", "cpu", "--rays", "256",
                            "--visits", "1"]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["variant"] for r in rows] == ["prod", "mma"]
    assert all(r["leaf"] == 32 and r["gtests_per_s"] > 0 for r in rows)
    # the plain tensor-core leaf finds the production body's winners
    tables, meta, arrays = leaf_bench.teapot_leaves(CPU)
    rays = leaf_bench.mesh_rays(arrays, 512, CPU, seed=3)
    pt, ps = leaf_bench.plain("prod", rays, tables, meta, 4)
    mt, ms = leaf_bench.plain("mma", rays, tables, meta, 4)
    hit = pt < mk._BIG
    assert hit.sum() > 20 and torch.equal(hit, mt < mk._BIG)
    assert torch.allclose(mt[hit], pt[hit], rtol=1e-5)
    assert (ms == ps).float().mean() > 0.99
    pairs, _ = leaf_bench.plain("pairs", rays, tables, meta, 1)
    assert pairs.shape == (512 * meta.leaf_size,)
    assert (pairs.reshape(512, -1).min(1).values < mk._BIG).sum() > 0
