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
    # the kernel's plane tiles, each the B fragment of a DMMA whose A is 8
    # rays: [leaf, tile, lane] = coefficient lane%4 (of the half of q the
    # group reads) of column lane//4. K > 4: tile g*ceil(K/8) + kt holds
    # group g's triangles 8*kt + column, 0 past K rows; K <= 4 (the port's
    # leaf): four tiles of two groups, (den, du), (dv, -), (num_t, ou),
    # (ov, -), triangle c in columns 2c and 2c+1. After the classic rows
    # under mxu
    ja, jm, ta, tm = _pair("teapot", monkeypatch, leaf)
    K = tm.leaf_size
    a, _ = mk.mxu_plane_arrays(ta, tm)
    frag = mk.mxu_fragments(a)
    nkt = -(-K // 8)
    assert frag.shape == (tm.n_tri_slots // K, 4 if K <= 4 else 6 * nkt, 32)
    for g, h in enumerate(mk._MXU_D_HALF):
        assert not a[:, g * K:(g + 1) * K, 4 * (1 - h):4 * (2 - h)].any()
    packed = ((0, 3), (5, None), (1, 2), (4, None))
    for t in range(frag.shape[1]):
        for lane in range(32):
            n, c = divmod(lane, 4)
            if K <= 4:
                g, r = packed[t][n % 2], n // 2
            else:
                g, r = t // nkt, 8 * (t % nkt) + n
            h = mk._MXU_D_HALF[g] if g is not None else 0
            want = (a[:, g * K + r, 4 * h + c]
                    if g is not None and r < K else 0.0)
            assert (frag[:, t, lane] == want).all()
    classic = mk.build_mesh_tables(ta, tm, "classic")[1]
    monkeypatch.setenv("PT_TRAVERSAL", "mxu")
    nodes, tris, shade = mk.build_mesh_tables(ta, tm)
    assert tris.shape == mk._table_shapes(tm, mk.scene_walk(tm))[2]
    assert np.array_equal(tris[:classic.shape[0]], classic)
    view = mk.mxu_view(torch.from_numpy(tris), tm).numpy()
    assert np.array_equal(view, frag)


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


@pytest.mark.parametrize("env,walk", [
    ({"PT_SUBPACKET": "2"}, ("block", "simt")),
    ({"PT_SUBPACKET": "1"}, ("block", "simt")),
    ({"PT_ABLATE_LEAF": "1"}, ("thread", "none")),
    ({"PT_TRAVERSAL": "mxu"}, None),
    # mode 3: the JAX gradient kernel runs its default walk under it (its
    # _packet_traverse reads modes 1 and 2 alone)
    ({"PT_SUBPACKET": "3"}, ("thread", "simt"))])
def test_gradient_kernel_refuses_the_walk_knobs(monkeypatch, env, walk):
    # the gradient kernel's walks (grad_walk): modes 1, 2 and 3 and the
    # ablation pass, MXU leaves raise as pallas_grad.py:1151 refuses them
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if walk is not None:
        assert mk.grad_walk() == mk.Walk(*walk)
        return
    with pytest.raises(NotImplementedError, match="classic-traversal only"):
        mk.grad_walk()


def test_gradient_under_mode_3_is_the_per_thread_walks(monkeypatch):
    """The gradient's plain version on a small `teapot` under
    PT_SUBPACKET=3 equals the gradient with the variable unset, bit for
    bit: object and triangle colors, through make_diff_render_tri's
    checks (which mode 3 passes) and grad_tiles."""
    from _torch_scenes import grad_inputs
    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.render import grad as tg
    from pathtracer_tpu_torch.scenes import get_scene
    cfg = RenderConfig(width=64, height=48, samples=2, samples_per_pass=2)
    tabs, meta, _, _ = grad_inputs(get_scene("teapot", cfg), cfg, (8, 128),
                                   CPU)
    rng = np.random.default_rng(5)
    cots = [torch.from_numpy(rng.random(tabs[-2].shape, dtype=np.float32))
            for _ in range(3)]
    kw = dict(meta=meta, cfg=cfg, spp=2, total_samples=2, tile=(8, 128),
              tri_grads=True)
    monkeypatch.delenv("PT_SUBPACKET", raising=False)
    want = tg.grad_tiles((7, 0), *tabs, *cots, **kw)
    monkeypatch.setenv("PT_SUBPACKET", "3")
    tg.make_diff_render_tri(meta, cfg, 2, (8, 128))
    got = tg.grad_tiles((7, 0), *tabs, *cots, **kw)
    assert len(got) == 3 and float(got[2].abs().max()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("env", [{"PT_SUBPACKET": "2"},
                                 {"PT_SUBPACKET": "3"},
                                 {"PT_ABLATE_LEAF": "1"},
                                 {"PT_TRAVERSAL": "mxu"}])
def test_f32_texel_forward_on_the_walks(monkeypatch, env):
    """The f32-texel forward (the texel gradients' primal) on the textured
    `teapot` under each walk of the knobs: its plain version, fetching the
    decoded pool, renders the rgb8 forward's sums on the same walk bit for
    bit; under MXU leaves it raises, as the differentiable render does."""
    from _torch_scenes import grad_inputs, textured_teapot
    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.render import proctex
    from pathtracer_tpu_torch.scene.pack import texel_params
    from pathtracer_tpu_torch.scenes import get_scene
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = RenderConfig(width=32, height=16, samples=2, samples_per_pass=2)
    sc = textured_teapot(get_scene("teapot", cfg), proctex.make)
    tabs, meta, arrays, _ = grad_inputs(sc, cfg, (8, 512), CPU)
    kw = dict(meta=meta, cfg=cfg, spp=2, total_samples=2, tile=(8, 512),
              **mk.texture_inputs(arrays, meta, CPU))
    f32 = dict(kw, tex_pool=None, tex_texels=texel_params(arrays))
    if mk.mesh_walk().leaf == "mma":
        with pytest.raises(NotImplementedError, match="classic-traversal"):
            mk.trace_tiles((3, 0), *tabs, **f32)
        return
    want = mk.trace_tiles((3, 0), *tabs, **kw)
    got = mk.trace_tiles((3, 0), *tabs, **f32)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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
