"""The CUDA megakernel of pathtracer_tpu_torch against its plain PyTorch
version, on the card. Imports no jax (the card's machine has none), so run
it without the repository's conftest, which pins jax to the CPU:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Every test skips without a CUDA device. Rule for the primitive scenes:
>= 99% of slot values within atol=1e-4, rtol=1e-3, each image-mean channel
within 1%. The mesh scenes must be bit-equal: the kernel and the plain
version walk each ray's BVH in the same order with the same f32 operations.

The textured instantiations (K1-tex) must be bit-equal to the plain
version on every textured scene: both fetch the same rgb8 texels and blend
them with the same f32 operations, and the texel-fetch probe
(fetch_texels, with the kernels' wrap and with the JAX kernel's) is
bit-equal to sample_pool; the fetches' wrap without a division equals the
JAX formula (wrap_check).

The gradient kernel (render/grad.py's grad_tiles) is held against
grad_tiles_reference by the gradient rule of tests/_torch_scenes.py: gcol
and gemi within 1e-4 * max|g| (1e-3 on mesh scenes), >= 99% of the
triangle slots within 1e-3 * max|gtri|. Its forward replay is the forward
kernel's code, and the differentiable render's primal stays bit-equal to
the plain render.

The texel mode (K6-tex, grad_tiles(tex_grads=True)) is held against its
plain version by the texel rule of tests/_torch_scenes.py (tex_grad_rule),
on `textures-train` and on a mesh scene with staged textures (the mesh
instantiation), and the f32-texel forward instantiations
(trace_tiles(tex_texels=...)) are bit-equal to the rgb8 ones when the
texels are the decoded pool.

Next-event estimation (the kNee instantiations, trace_tiles under cfg.nee)
and the intersect-only kernel (intersect_batch) must be bit-equal to their
plain versions: the same f32 operations in the same order, and the card's
sin/cos on both sides (the light point's sincosf equals torch.sin and
torch.cos on every f32 angle it can take); the kernel's shadow query
(light_visible) at exact ties too (tie_scene).

The mesh walks of the JAX package's knobs (PT_SUBPACKET, PT_ABLATE_LEAF:
the warp-packet walk and the node walk alone) must be bit-equal to their
plain versions too; the tensor-core leaves (PT_TRAVERSAL=mxu) hold by the
per-slot rule, and the leaf microbenchmark's tensor-core test holds every
ray x triangle t within one ulp (probes/leaf_bench.py check).

The wavefront integrator (render/integrator.py) sends its f32 bounces and
shadow rays through the intersect kernel on the card: on its own rays the
kernel is bit-equal to its plain version at every call of a pass, and so
is the pass's image.
"""
import numpy as np
import pytest
import torch

from _torch_scenes import (MESH_SCENES, SLICE_SCENES, TEX_SCENES,
                           ablated_grad_rule, assert_slot_rule, at_backward,
                           cylinder_scene, filter_cases, free_bytes,
                           free_for, grad_inputs,
                           grad_rule, one_warp_live,
                           port_inputs, sincos_mismatches, size_check_scene,
                           tex_grad_rule, textured_teapot, tie_scene)
from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.diff import make_megakernel_step
from pathtracer_tpu_torch.geometry import transforms as gx
from pathtracer_tpu_torch.io.raw import read_raw
from pathtracer_tpu_torch.render import grad as tg
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.render import proctex
from pathtracer_tpu_torch.scene import material, pack, shapes
from pathtracer_tpu_torch.scene.pack import texel_params
from pathtracer_tpu_torch.scenes import cornell, get_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(name, dev, tile, **cfg_kw):
    cfg = RenderConfig(**cfg_kw)
    if name == "cylinder":
        sc = cylinder_scene(cfg, gx, material, shapes, pack, cornell)
    elif name == "size-check":
        sc = size_check_scene(cfg, get_scene)
    else:
        sc = get_scene(name, cfg)
    tabs, meta, _, layout = port_inputs(sc, cfg, tile, dev)
    return tabs, meta, cfg, layout


@pytest.mark.parametrize("tile", [(8, 128), (64, 256)])
@pytest.mark.parametrize("name,aperture,base",
                         [(n, 0.0, 0) for n in SLICE_SCENES]
                         + [("cylinder", 0.0, 0), ("reference", 0.1, 16)])
def test_kernel_matches_plain(dev, tile, name, aperture, base):
    tabs, meta, cfg, layout = _inputs(name, dev, tile, width=160,
                                      height=120, samples=8,
                                      aperture=aperture,
                                      focal_length=1.6 if aperture else 0.0)
    kw = dict(meta=meta, cfg=cfg, spp=8, total_samples=8 + base, tile=tile,
              **layout)
    before = mk.trace_tiles.launches
    got = torch.stack(mk.trace_tiles((5, base), *tabs, **kw))
    assert mk.trace_tiles.launches == before + 1
    want = torch.stack(mk.trace_tiles_reference((5, base), *tabs, **kw))
    torch.cuda.synchronize()
    assert_slot_rule(got.cpu().numpy(), want.cpu().numpy())


def test_kernel_matches_plain_incoherent(dev, monkeypatch):
    # PT_COHERENT=0 switches the kernel's roulette and hemisphere draws
    # from row-shared to per slot, on both sides
    monkeypatch.setenv("PT_COHERENT", "0")
    tabs, meta, cfg, layout = _inputs("transparency_f_light", dev,
                                      (64, 256), width=160, height=120,
                                      samples=8)
    kw = dict(meta=meta, cfg=cfg, spp=8, total_samples=8, tile=(64, 256),
              **layout)
    got = torch.stack(mk.trace_tiles((5, 0), *tabs, **kw))
    want = torch.stack(mk.trace_tiles_reference((5, 0), *tabs, **kw))
    torch.cuda.synchronize()
    assert_slot_rule(got.cpu().numpy(), want.cpu().numpy())
    monkeypatch.setenv("PT_COHERENT", "1")
    assert not torch.equal(got, torch.stack(mk.trace_tiles((5, 0), *tabs,
                                                           **kw)))


@pytest.mark.parametrize("name,aperture,base,env", [
    (n, 0.0, 0, {}) for n in MESH_SCENES] + [
    ("teapot", 0.1, 16, {}),                     # DoF over chunk replicas
    ("teapot", 0.1, 16, {"PT_PACK_AXIS": "row"}),
    ("teapot", 0.0, 0, {"PT_OCTANT": "0"}),
    ("teapot", 0.0, 0, {"PT_COHERENT": "0"}),
    ("size-check", 0.0, 0, {}),                  # 16640 triangles, leaf 4
    ("teapot", 0.0, 0, {"PT_BVH_LEAF": "32"}),   # the other leaf sizes
    ("teapot", 0.0, 0, {"PT_BVH_LEAF": "8"}),    # timed
    ("size-check", 0.0, 0, {"PT_BVH_LEAF": "16"}),
])
def test_mesh_kernel_bit_equal_plain(dev, monkeypatch, name, aperture, base,
                                     env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tile = (8, 512)
    tabs, meta, cfg, layout = _inputs(name, dev, tile, width=160,
                                      height=120, samples=8,
                                      aperture=aperture,
                                      focal_length=1.6 if aperture else 0.0)
    assert meta.has_groups
    kw = dict(meta=meta, cfg=cfg, spp=8, total_samples=8 + base, tile=tile,
              **layout)
    before = mk.trace_tiles.launches
    got = torch.stack(mk.trace_tiles((5, base), *tabs, **kw))
    assert mk.trace_tiles.launches == before + 1
    want = torch.stack(mk.trace_tiles_reference((5, base), *tabs, **kw))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), (got != want).float().mean().item()


@pytest.mark.parametrize("name,aperture,base", [
    (n, 0.0, 0) for n in TEX_SCENES] + [("textures", 0.1, 16)])
def test_tex_kernel_bit_equal_plain(dev, name, aperture, base):
    cfg = RenderConfig(width=160, height=120, samples=8, aperture=aperture,
                       focal_length=1.6 if aperture else 0.0)
    tabs, meta, _, kw = port_inputs(get_scene(name, cfg), cfg, None, dev)
    tile = mk.default_tile(meta)
    assert mk.has_textures(meta) and "tex_pool" in kw
    kw.update(meta=meta, cfg=cfg, spp=8, total_samples=8 + base, tile=tile)
    before = mk.trace_tiles.tex_launches
    got = torch.stack(mk.trace_tiles((5, base), *tabs, **kw))
    assert mk.trace_tiles.tex_launches == before + 1
    want = torch.stack(mk.trace_tiles_reference((5, base), *tabs, **kw))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), (got != want).float().mean().item()


def test_tex_fetch_bit_equal_sample_pool(dev):
    # the kernel's device fetch function alone, at random UVs in [-2, 3]
    # (the REPEAT wrap) over the 2048x1024 sky of `envmap`
    sc = get_scene("envmap", RenderConfig(width=8, height=6))
    arrays, _ = sc.pack(device=dev)
    pool = arrays.tex_pool_u32.view(torch.int32)
    rng = np.random.default_rng(0)
    u, v = (torch.from_numpy(rng.uniform(-2, 3, 1 << 16).astype(np.float32))
            .to(dev) for _ in range(2))
    before = mk.fetch_texels.launches
    got = torch.stack(mk.fetch_texels(pool, 0, 2048, 1024, u, v))
    assert mk.fetch_texels.launches == before + 1
    f = lambda x: torch.full_like(u, float(x))
    want = torch.stack(mk.sample_pool(pool, f(0), f(2048), f(1024), u, v))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_tex_fetch_jax_wrap_bit_equal_sample_pool(dev):
    # the fetch with the JAX kernel's wrap alone (the probe's reference),
    # and the kernels' at anchors past 2^22 in magnitude (the cold branch)
    sc = get_scene("envmap", RenderConfig(width=8, height=6))
    arrays, _ = sc.pack(device=dev)
    pool = arrays.tex_pool_u32.view(torch.int32)
    rng = np.random.default_rng(1)
    uv = np.concatenate([rng.uniform(-2, 3, 1 << 16),
                         rng.uniform(-1e4, 1e4, 1 << 10)]).astype(np.float32)
    u, v = (torch.from_numpy(rng.permutation(uv)).to(dev) for _ in range(2))
    f = lambda x: torch.full_like(u, float(x))
    want = torch.stack(mk.sample_pool(pool, f(0), f(2048), f(1024), u, v))
    before = mk.fetch_texels.launches
    for fast in (True, False):
        got = torch.stack(mk.fetch_texels(pool, 0, 2048, 1024, u, v, fast))
        assert torch.equal(got, want)
    assert mk.fetch_texels.launches == before + 2


def test_wrap_check_on_the_card(dev):
    # the fetches' division-free wrap against the JAX formula
    before = mk.wrap_check.launches
    fast, bad = mk.wrap_check(2048, -(1 << 23), 1 << 23, dev)
    assert mk.wrap_check.launches == before + 1
    assert (fast, bad) == ((1 << 23) - 1, 0)


@pytest.mark.parametrize("code", [shapes.PLANE, shapes.SPHERE,
                                  shapes.CYLINDER])
def test_filter_check_on_the_card(dev, code):
    # the object loop's filter against the exact tests on 2^22 cases (the
    # chip_smoke phase takes 2^28 a type): no skipped winner, and the same
    # cases skipped as by the plain filter on the CPU
    ray, thr = filter_cases(code, 1 << 22, 5, dev, 1e-4, 0.0, 0.4)
    before = mk.filter_check.launches
    skipped, bad = mk.filter_check(code, ray, thr, 1e-4, 0.0, 0.4)
    assert mk.filter_check.launches == before + 1
    assert bad == 0 and skipped > 0
    cpu = mk.filter_check(code, ray.cpu(), thr.cpu(), 1e-4, 0.0, 0.4)
    assert (skipped, bad) == cpu


def test_kernel_refuses_tables_off_the_card(dev):
    tabs, meta, cfg, _ = _inputs("reference", dev, (8, 128), width=32,
                                 height=24)
    tabs[1] = tabs[1].cpu()
    with pytest.raises(ValueError, match="obj_table"):
        mk.trace_tiles((0, 0), *tabs, meta=meta, cfg=cfg, spp=1,
                       total_samples=1, tile=(8, 128))


def test_kernel_refuses_unaligned_mesh_tables(dev):
    # the kernel reads the mesh records as float4: a table that does not
    # start on a 16-byte boundary is refused, not read
    tabs, meta, cfg, layout = _inputs("teapot", dev, (8, 512), width=32,
                                      height=24, samples=4)
    kw = dict(meta=meta, cfg=cfg, spp=4, total_samples=4, tile=(8, 512),
              **layout)
    for i in (2, 3, 4):
        bad = list(tabs)
        t = tabs[i]
        bad[i] = torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape)
        bad[i].copy_(t)
        with pytest.raises(ValueError, match="16-byte"):
            mk.trace_tiles((5, 0), *bad, **kw)


def test_cli_renders_through_the_kernel(dev, tmp_path):
    raw = tmp_path / "r.raw"
    before = mk.trace_tiles.launches
    rc = cli.main(["--scene", "reference", "--width", "64", "--height",
                   "48", "--samples", "32", "--raw-output", str(raw),
                   "--output", str(tmp_path / "r.png")])
    assert rc == 0
    assert mk.trace_tiles.launches == before + 1   # 32 spp = 1 segment
    img = read_raw(str(raw))
    assert img.shape == (48, 64, 3) and np.isfinite(img).all()
    left, right = img[:, :3].mean((0, 1)), img[:, -3:].mean((0, 1))
    assert left[0] > left[2] and right[2] > right[0]


def test_cli_renders_teapot_through_the_kernel(dev, tmp_path):
    raw = tmp_path / "t.raw"
    before = mk.trace_tiles.launches
    rc = cli.main(["--scene", "teapot", "--width", "64", "--height", "48",
                   "--samples", "16", "--raw-output", str(raw),
                   "--output", str(tmp_path / "t.png")])
    assert rc == 0
    assert mk.trace_tiles.launches == before + 2   # 8-spp mesh segments
    img = read_raw(str(raw))
    assert img.shape == (48, 64, 3) and np.isfinite(img).all()
    left, right = img[:, :3].mean((0, 1)), img[:, -3:].mean((0, 1))
    assert left[0] > left[2] and right[2] > right[0]


def test_cli_renders_textures_through_the_kernel(dev, tmp_path):
    raw = tmp_path / "x.raw"
    before = mk.trace_tiles.tex_launches
    rc = cli.main(["--scene", "textures", "--width", "64", "--height", "48",
                   "--samples", "32", "--raw-output", str(raw),
                   "--output", str(tmp_path / "x.png")])
    assert rc == 0
    assert mk.trace_tiles.tex_launches == before + 1   # 1 segment
    img = read_raw(str(raw))
    assert img.shape == (48, 64, 3) and np.isfinite(img).all()
    assert img.min() >= 0.0 and img.mean() > 0.1


def _grad_case(name, dev, **cfg_kw):
    cfg = RenderConfig(**cfg_kw)
    sc = (size_check_scene(cfg, get_scene) if name == "size-check"
          else get_scene(name, cfg))
    tabs, meta, arrays, pid = grad_inputs(sc, cfg, (8, 512), dev)
    rng = np.random.default_rng(0)
    cots = [torch.from_numpy(rng.random(tuple(tabs[-2].shape),
                                        dtype=np.float32)).to(dev)
            for _ in range(3)]
    return tabs, meta, arrays, pid, cfg, cots


@pytest.mark.parametrize("name,aperture,base,tri", [
    ("reference", 0.0, 0, False),
    ("reference", 0.1, 16, False),            # DoF
    ("transparency", 0.0, 0, False),          # glass and mirror spheres
    ("teapot", 0.0, 0, False),                # mesh, object gradients only
    ("teapot", 0.0, 0, True),
    ("teapot", 0.1, 16, True),
    ("size-check", 0.0, 0, True),             # 16640 triangles, leaf 4
])
def test_grad_kernel_matches_plain(dev, name, aperture, base, tri):
    tabs, meta, _, _, cfg, cots = _grad_case(
        name, dev, width=160, height=120, samples=4, aperture=aperture,
        focal_length=1.6 if aperture else 0.0)
    kw = dict(meta=meta, cfg=cfg, spp=4, total_samples=4 + base,
              tile=(8, 512), tri_grads=tri)
    before = (tg.grad_tiles.launches, tg.grad_tiles.tri_launches)
    got = tg.grad_tiles((5, base), *tabs, *cots, **kw)
    assert (tg.grad_tiles.launches, tg.grad_tiles.tri_launches) == (
        before[0] + 1, before[1] + int(tri))
    want = tg.grad_tiles_reference((5, base), *tabs, *cots, **kw)
    torch.cuda.synchronize()
    assert len(got) == (3 if tri else 2)
    grad_rule(got, want, meta.has_groups)


def test_grad_kernel_under_mode_3(dev, monkeypatch):
    # PT_SUBPACKET=3 passes the gradient path's check and runs the
    # per-thread walk, as the JAX gradient kernel runs its default walk
    # under it: the plain version's gradients are bit-equal to those with
    # the variable unset; the kernel's, whose atomic adds land in another
    # order from launch to launch, are held to the gradient rule against
    # the unset launch and against the plain version
    tabs, meta, _, _, cfg, cots = _grad_case("teapot", dev, width=160,
                                             height=120, samples=4)
    kw = dict(meta=meta, cfg=cfg, spp=4, total_samples=4, tile=(8, 512),
              tri_grads=True)
    monkeypatch.delenv("PT_SUBPACKET", raising=False)
    want = tg.grad_tiles((5, 0), *tabs, *cots, **kw)
    want_plain = tg.grad_tiles_reference((5, 0), *tabs, *cots, **kw)
    monkeypatch.setenv("PT_SUBPACKET", "3")
    before = tg.grad_tiles.tri_launches
    got = tg.grad_tiles((5, 0), *tabs, *cots, **kw)
    assert tg.grad_tiles.tri_launches == before + 1
    got_plain = tg.grad_tiles_reference((5, 0), *tabs, *cots, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got_plain, want_plain):
        assert torch.equal(a, b)
    grad_rule(got, want, True)
    grad_rule(got, got_plain, True)


@pytest.mark.parametrize("name,mode", [
    ("reference", "object"), ("teapot", "triangle"),
    ("size-check", "triangle"), ("textures-train", "texel")])
def test_grad_kernel_matches_plain_at_32_spp(dev, name, mode):
    # the training steps' launch size: the sums of 32 samples a slot,
    # merged per warp and added in f32, within the gradient rule
    tabs, meta, arrays, _, cfg, cots = _grad_case(name, dev, width=160,
                                                  height=120, samples=32)
    kw = dict(meta=meta, cfg=cfg, spp=32, total_samples=32, tile=(8, 512),
              tri_grads=mode == "triangle")
    if mode == "texel":
        kw.update(tex_grads=True, tex=texel_params(arrays),
                  tex_table=torch.from_numpy(mk.build_tex_table(
                      arrays, meta)).to(dev))
    got = tg.grad_tiles((5, 0), *tabs, *cots, **kw)
    want = tg.grad_tiles_reference((5, 0), *tabs, *cots, **kw)
    torch.cuda.synchronize()
    if mode == "texel":
        tex_grad_rule(got, want)
    else:
        grad_rule(got, want, meta.has_groups)


def _aimed(sc, cfg, look_at, fov):
    """Scene `sc` seen from its camera's position toward `look_at` through
    a field of view of `fov` radians."""
    from pathtracer_tpu_torch.render.camera import Camera
    c = sc.camera
    origin = c.inverse @ np.array([0.0, 0.0, 0.0, 1.0])
    sc.camera = Camera(cfg.width, cfg.height, fov, origin,
                       np.append(np.asarray(look_at, np.float64), 1.0))
    return sc


def test_grad_kernel_every_lane_on_one_object(dev):
    # a field of view of 1e-4 rad: every lane of every block hits the back
    # wall first, so each warp merges all 32 lanes' first-bounce sums into
    # one group (the widest merge) before one lane adds them
    cfg = RenderConfig(width=160, height=120, samples=4)
    sc = _aimed(get_scene("reference", cfg), cfg, (0.0, 0.05, 0.0), 1e-4)
    tabs, meta, _, _ = grad_inputs(sc, cfg, (8, 512), dev)
    rng = np.random.default_rng(0)
    cots = [torch.from_numpy(rng.random(tuple(tabs[-2].shape),
                                        dtype=np.float32)).to(dev)
            for _ in range(3)]
    kw = dict(meta=meta, cfg=cfg, spp=4, total_samples=4, tile=(8, 512))
    counts = {}
    want = tg.grad_tiles_reference((5, 0), *tabs, *cots, counts=counts,
                                   **kw)
    got = tg.grad_tiles((5, 0), *tabs, *cots, **kw)
    torch.cuda.synchronize()
    assert counts["hits"] >= counts["samples"]
    grad_rule(got, want, False)


def test_grad_kernel_each_lane_on_its_own_triangle(dev):
    # the size-check mesh (16640 triangles, a sphere of radius 0.07 at 1.58
    # from the camera) seen through 0.15 rad at 64x48: about 1100 pixels
    # on its near half's 8320 triangles, so the lanes of a warp hit
    # different triangles and the merge leaves groups of one, each adding
    # its own 16-byte row of gtri
    from pathtracer_tpu_torch.scene.bounds import parent_space_bounds
    cfg = RenderConfig(width=64, height=48, samples=4)
    sc = size_check_scene(cfg, get_scene)
    group = next(o for o in sc.objects if isinstance(o, shapes.Group))
    box = parent_space_bounds(group)
    sc = _aimed(sc, cfg, (box.min[:3] + box.max[:3]) / 2, 0.15)
    tabs, meta, _, _ = grad_inputs(sc, cfg, (8, 512), dev)
    rng = np.random.default_rng(0)
    cots = [torch.from_numpy(rng.random(tuple(tabs[-2].shape),
                                        dtype=np.float32)).to(dev)
            for _ in range(3)]
    kw = dict(meta=meta, cfg=cfg, spp=4, total_samples=4, tile=(8, 512),
              tri_grads=True)
    want = tg.grad_tiles_reference((5, 0), *tabs, *cots, **kw)
    got = tg.grad_tiles((5, 0), *tabs, *cots, **kw)
    torch.cuda.synchronize()
    out = grad_rule(got, want, True)
    assert out["gtri_slots_hit"] > 100


@pytest.mark.parametrize("name", ["reference", "teapot"])
def test_diff_render_primal_is_bit_equal(dev, name):
    # the autograd Function's forward is the forward kernel on the
    # assembled tables: bit-equal to the plain render; its backward is one
    # gradient-kernel launch
    tabs, meta, arrays, _, cfg, _ = _grad_case(name, dev, width=160,
                                               height=120, samples=4)
    kw = dict(meta=meta, cfg=cfg, spp=4, total_samples=4, tile=(8, 512))
    color = arrays.color.clone().requires_grad_(True)
    if meta.has_groups:
        render = tg.make_diff_render_tri(meta, cfg, 4, (8, 512), spp=4)
        params = (color, arrays.emission, arrays.tri_color)
    else:
        render = tg.make_diff_render(meta, cfg, 4, 4, (8, 512))
        params = (color, arrays.emission)
    rgb = render.apply(*params, (2, 0), *tabs)
    want = mk.trace_tiles_reference((2, 0), *tabs, **kw)
    for x, y in zip(rgb, want):
        assert torch.equal(x.detach(), y)
    before = tg.grad_tiles.launches
    (gc,) = torch.autograd.grad(rgb[0].sum(), (color,))
    assert tg.grad_tiles.launches == before + 1
    zero = torch.zeros_like(tabs[-2], dtype=torch.float32)
    want_gc = tg.grad_tiles_reference((2, 0), *tabs, torch.ones_like(zero),
                                      zero, zero, **kw)[0]
    n = meta.n_objects
    assert not gc[n:].any() and not gc[:, 1:].any()
    rel = (gc[:n] - want_gc).abs().max() / want_gc.abs().max()
    assert rel < (1e-3 if meta.has_groups else 1e-4), float(rel)


def test_megakernel_step_descends_on_the_card(dev):
    cfg = RenderConfig(width=64, height=48, samples=8, samples_per_pass=8)
    sc = get_scene("reference", cfg)
    tabs, meta, arrays, pid = grad_inputs(sc, cfg, (8, 512), dev)
    step, target_of = make_megakernel_step(arrays, meta, cfg, sc.camera,
                                           spp=8, lr=0.2)
    seed = (7, 0)
    rgb = mk.trace_tiles(seed, *tabs, meta=meta, cfg=cfg, spp=8,
                         total_samples=8, tile=(8, 512))
    flat = torch.stack(rgb, -1).reshape(-1, 3).cpu().numpy() / 8
    target = target_of(mk.untile_image(flat, pid, 64, 48).reshape(48, 64, 3))
    c = arrays.color.clone()
    c[1, 0] += 0.3
    c[6, 2] -= 0.2
    e = arrays.emission
    losses = []
    for _ in range(3):
        c, e, loss = step(c, e, seed, target)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < 0.9 * losses[0], losses


@pytest.mark.parametrize("name", ["textures-train", "textures", "cubemap"])
def test_f32_texel_kernel_bit_equal_rgb8(dev, name):
    # the f32-texel instantiations (`cubemap`: the mesh one) fetching the
    # decoded pool render the rgb8 instantiations' sums bit for bit
    cfg = RenderConfig(width=160, height=120, samples=8)
    sc = get_scene(name, cfg)
    tabs, meta, _, kw = port_inputs(sc, cfg, None, dev)
    arrays, _ = sc.pack(device=dev)
    kw.update(meta=meta, cfg=cfg, spp=8, total_samples=8,
              tile=mk.default_tile(meta))
    want = torch.stack(mk.trace_tiles((5, 0), *tabs, **kw))
    kw.pop("tex_pool")
    before = mk.trace_tiles.texel_launches
    got = torch.stack(mk.trace_tiles((5, 0), *tabs, **kw,
                                     tex_texels=texel_params(arrays)))
    assert mk.trace_tiles.texel_launches == before + 1
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), (got != want).float().mean().item()


@pytest.mark.parametrize("name,aperture,base", [
    ("textures-train", 0.0, 0), ("textures-train", 0.1, 16)])
def test_tex_grad_kernel_matches_plain(dev, name, aperture, base):
    tabs, meta, arrays, _, cfg, cots = _grad_case(
        name, dev, width=160, height=120, samples=4, aperture=aperture,
        focal_length=1.6 if aperture else 0.0)
    rng = np.random.default_rng(1)
    tex = texel_params(arrays)
    tex = (tex + torch.from_numpy(rng.uniform(
        -0.1, 0.1, tuple(tex.shape)).astype(np.float32)).to(dev)).clamp(0, 1)
    kw = dict(meta=meta, cfg=cfg, spp=4, total_samples=4 + base,
              tile=(8, 512), tex_grads=True, tex=tex,
              tex_table=torch.from_numpy(mk.build_tex_table(arrays, meta))
              .to(dev))
    before = (tg.grad_tiles.launches, tg.grad_tiles.tex_launches)
    got = tg.grad_tiles((5, base), *tabs, *cots, **kw)
    assert (tg.grad_tiles.launches, tg.grad_tiles.tex_launches) == (
        before[0] + 1, before[1] + 1)
    want = tg.grad_tiles_reference((5, base), *tabs, *cots, **kw)
    torch.cuda.synchronize()
    assert len(got) == 3
    tex_grad_rule(got, want)
    # no gradient outside the staged textures' texels
    assert not got[2][~pack.trainable_texels(arrays, meta)].any()


def test_diff_render_tex_primal_is_bit_equal(dev):
    tabs, meta, arrays, _, cfg, _ = _grad_case("textures-train", dev,
                                               width=160, height=120,
                                               samples=4)
    table = torch.from_numpy(mk.build_tex_table(arrays, meta)).to(dev)
    render = tg.make_diff_render_tex(meta, cfg, 4, 4, (8, 512))
    tex = texel_params(arrays).requires_grad_(True)
    rgb = render.apply(arrays.color, arrays.emission, tex, (2, 0), *tabs,
                       table)
    want = mk.trace_tiles_reference(
        (2, 0), *tabs, meta=meta, cfg=cfg, spp=4, total_samples=4,
        tile=(8, 512), tex_table=table, tex_texels=tex.detach())
    for x, y in zip(rgb, want):
        assert torch.equal(x.detach(), y)
    before = tg.grad_tiles.tex_launches
    (gt,) = torch.autograd.grad(sum(x.sum() for x in rgb), (tex,))
    assert tg.grad_tiles.tex_launches == before + 1
    assert torch.isfinite(gt).all() and gt.abs().max() > 0



def test_tex_grad_kernel_matches_plain_on_a_mesh(dev):
    # the `teapot` stand-in with staged file textures on its floor and
    # sphere launches the mesh texel-gradient instantiation <true, true,
    # true, true>
    cfg = RenderConfig(width=160, height=120, samples=4)
    sc = textured_teapot(get_scene("teapot", cfg), proctex.make)
    tabs, meta, arrays, _ = grad_inputs(sc, cfg, (8, 512), dev)
    assert meta.has_groups and pack.staged_objects(meta)
    rng = np.random.default_rng(0)
    cots = [torch.from_numpy(rng.random(tuple(tabs[-2].shape),
                                        dtype=np.float32)).to(dev)
            for _ in range(3)]
    kw = dict(meta=meta, cfg=cfg, spp=4, total_samples=4, tile=(8, 512),
              tex_grads=True, tex=texel_params(arrays),
              tex_table=torch.from_numpy(mk.build_tex_table(arrays, meta))
              .to(dev))
    before = tg.grad_tiles.tex_launches
    got = tg.grad_tiles((5, 0), *tabs, *cots, **kw)
    assert tg.grad_tiles.tex_launches == before + 1
    want = tg.grad_tiles_reference((5, 0), *tabs, *cots, **kw)
    torch.cuda.synchronize()
    tex_grad_rule(got, want)


NEE_CASES = [("reference", (64, 256), 0.0, {}),
             ("transparency_quad_lights", (64, 256), 0.0, {}),
             ("transparency_f_light", (64, 256), 0.0, {}),
             ("teapot", (8, 512), 0.0, {}),         # the mesh shadow walk
             ("textures", None, 0.0, {}),
             ("cubemap", None, 0.0, {}),            # textured mesh
             ("reference", (64, 256), 0.1, {}),     # DoF
             ("reference", (64, 256), 0.0, {"PT_COHERENT": "0"})]


@pytest.mark.parametrize("name,tile,aperture,env", NEE_CASES)
def test_nee_kernel_bit_equal_plain(dev, monkeypatch, name, tile, aperture,
                                    env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = RenderConfig(width=160, height=120, samples=8, nee=True,
                       aperture=aperture,
                       focal_length=1.6 if aperture else 0.0)
    tabs, meta, _, kw = port_inputs(get_scene(name, cfg), cfg, tile, dev)
    assert meta.light_indices
    base = 16 if aperture else 0
    kw.update(meta=meta, cfg=cfg, spp=8, total_samples=8 + base,
              tile=tile or mk.default_tile(meta))
    before = (mk.trace_tiles.launches, mk.trace_tiles.nee_launches)
    got = torch.stack(mk.trace_tiles((5, base), *tabs, **kw))
    assert (mk.trace_tiles.launches, mk.trace_tiles.nee_launches) == (
        before[0] + 1, before[1] + 1)
    counts = {}
    want = torch.stack(mk.trace_tiles_reference((5, base), *tabs, **kw,
                                                counts=counts))
    torch.cuda.synchronize()
    assert counts["shadow_lit"] > 0
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), (got != want).float().mean().item()


@pytest.mark.parametrize("base,tile", [("reference", (64, 256)),
                                       ("teapot", (8, 512))])
def test_nee_query_ties_bit_equal_plain(dev, base, tile):
    # the shadow query at exact ties: each light with a copy of itself
    # after it (stays lit) and before it (never lit)
    cfg = RenderConfig(width=160, height=120, samples=8, nee=True)
    tabs, meta, _, kw = port_inputs(tie_scene(cfg, get_scene, base), cfg,
                                    tile, dev)
    kw.update(meta=meta, cfg=cfg, spp=8, total_samples=8, tile=tile)
    got = torch.stack(mk.trace_tiles((5, 0), *tabs, **kw))
    counts = {}
    want = torch.stack(mk.trace_tiles_reference((5, 0), *tabs, **kw,
                                                counts=counts))
    torch.cuda.synchronize()
    assert counts["shadow_lit"] > 0 and counts["shadow_occluded"] > 0
    assert torch.equal(got, want), (got != want).float().mean().item()


def test_light_sincos_bit_equal_torch(dev):
    # the light point's sincosf against torch.sin and torch.cos on every
    # f32 of its latitudes and longitudes
    before = mk.light_sincos.launches
    n, bad = sincos_mismatches(mk.light_sincos, dev)
    assert mk.light_sincos.launches > before
    assert n > 1_000_000_000 and bad == 0, (n, bad)


def test_cli_renders_nee_through_the_kernel(dev, tmp_path):
    raw = tmp_path / "n.raw"
    before = mk.trace_tiles.nee_launches
    rc = cli.main(["--scene", "reference", "--nee", "--width", "64",
                   "--height", "48", "--samples", "32", "--raw-output",
                   str(raw), "--output", str(tmp_path / "n.png")])
    assert rc == 0
    assert mk.trace_tiles.nee_launches == before + 1
    img = read_raw(str(raw))
    assert img.shape == (48, 64, 3) and np.isfinite(img).all()


@pytest.mark.parametrize("name", ["reference", "teapot", "size-check",
                                  "cylinder", "cubemap"])
def test_intersect_kernel_bit_equal_plain(dev, name):
    cfg = RenderConfig(width=160, height=120, samples=1)
    if name == "cylinder":
        sc = cylinder_scene(cfg, gx, material, shapes, pack, cornell)
    elif name == "size-check":
        sc = size_check_scene(cfg, get_scene)
    else:
        sc = get_scene(name, cfg)
    arrays, meta = sc.pack(device=dev)
    tables = mk.intersect_tables(arrays, meta, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    R = 1 << 16
    o = tuple((torch.rand(R, generator=gen, device=dev) - 0.5).contiguous()
              for _ in range(3))
    d = torch.randn((3, R), generator=gen, device=dev)
    d = tuple((d / torch.linalg.vector_norm(d, dim=0)).contiguous())
    before = mk.intersect_batch.launches
    got = mk.intersect_batch(arrays, meta, cfg, o, d, tables=tables)
    assert mk.intersect_batch.launches == before + 1
    want = mk.intersect_batch_reference(arrays, meta, cfg, o, d, tables)
    torch.cuda.synchronize()
    assert len(_flat(got)) == len(_flat(want)) == 16
    for a, b in zip(_flat(got), _flat(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[1].dtype == torch.int32 and got[4].dtype == torch.bool
    if meta.has_groups:
        assert got[4].any()


# ---- the mesh walks of the JAX package's knobs (Kernels A and B) --------

WALK_ENVS = {"mode1": {"PT_SUBPACKET": "1"}, "mode2": {"PT_SUBPACKET": "2"},
             "mode3": {"PT_SUBPACKET": "3"}, "mxu": {"PT_TRAVERSAL": "mxu"},
             "ablate": {"PT_ABLATE_LEAF": "1"},
             "ablate2": {"PT_SUBPACKET": "2", "PT_ABLATE_LEAF": "1"}}


@pytest.mark.parametrize("walk", list(WALK_ENVS))
@pytest.mark.parametrize("name,nee,leaf", [
    ("teapot", False, None), ("teapot", True, None),
    ("size-check", False, None), ("cubemap", False, None),
    ("teapot", False, 32), ("teapot", False, 8)])  # other leaf sizes
def test_packet_walks_match_plain(dev, monkeypatch, walk, name, nee, leaf):
    # Kernel A (the warp-packet walk) and the node walk alone bit for bit;
    # Kernel B (tensor-core leaves) by the per-slot rule (its plain dots
    # are f64 rounded once, as the DMMA's)
    for k, v in WALK_ENVS[walk].items():
        monkeypatch.setenv(k, v)
    if leaf is not None:
        monkeypatch.setenv("PT_BVH_LEAF", str(leaf))
    tabs, meta, cfg, layout = _inputs(name, dev, None, width=64, height=48,
                                      samples=4, samples_per_pass=4, nee=nee)
    kw = dict(meta=meta, cfg=cfg, spp=4, total_samples=4,
              tile=mk.default_tile(meta), **layout)
    before = (mk.trace_tiles.packet_launches, mk.trace_tiles.mma_launches)
    got = torch.stack(mk.trace_tiles((3, 0), *tabs, **kw))
    want = torch.stack(mk.trace_tiles_reference((3, 0), *tabs, **kw))
    torch.cuda.synchronize()
    packet = mk.mesh_walk().walk != "thread"
    assert mk.trace_tiles.packet_launches == before[0] + packet
    assert mk.trace_tiles.mma_launches == before[1] + (walk == "mxu")
    if walk == "mxu":
        assert_slot_rule(got.cpu().numpy(), want.cpu().numpy())
    else:
        assert torch.equal(got, want)


# the gradient kernel's walks (grad_walk): modes 1 and 2 take the block
# packet walk, PT_ABLATE_LEAF=1 the node walk alone on either walk
@pytest.mark.parametrize("walk", ["mode1", "mode2", "ablate", "ablate2"])
@pytest.mark.parametrize("name,mode", [
    ("teapot", "object"), ("teapot", "triangle"),
    ("size-check", "triangle"), ("textured teapot", "texel")])
def test_grad_kernel_on_the_walks_matches_plain(dev, monkeypatch, walk, name,
                                               mode):
    # each walk's gradient instantiation against the plain version on the
    # same walk: the gradient rule (the texel rule in texel mode; without
    # leaf tests every triangle gradient is exactly zero), and its launch
    # in the walk's counter
    for k, v in WALK_ENVS[walk].items():
        monkeypatch.setenv(k, v)
    cfg = RenderConfig(width=160, height=120, samples=4)
    if name == "textured teapot":
        sc = textured_teapot(get_scene("teapot", cfg), proctex.make)
    else:
        sc = (size_check_scene(cfg, get_scene) if name == "size-check"
              else get_scene(name, cfg))
    tabs, meta, arrays, _ = grad_inputs(sc, cfg, (8, 512), dev)
    rng = np.random.default_rng(0)
    cots = [torch.from_numpy(rng.random(tuple(tabs[-2].shape),
                                        dtype=np.float32)).to(dev)
            for _ in range(3)]
    kw = dict(meta=meta, cfg=cfg, spp=4, total_samples=4, tile=(8, 512),
              tri_grads=mode == "triangle")
    if mode == "texel":
        kw.update(tex_grads=True, tex=texel_params(arrays),
                  tex_table=torch.from_numpy(mk.build_tex_table(
                      arrays, meta)).to(dev))
    w = mk.grad_walk()
    counters = ("launches", "packet_launches", "ablate_launches",
                "tri_launches", "tex_launches")
    before = [getattr(tg.grad_tiles, c) for c in counters]
    got = tg.grad_tiles((5, 0), *tabs, *cots, **kw)
    assert [getattr(tg.grad_tiles, c) - b for c, b in
            zip(counters, before)] == [
        1, w.walk == "block", w.leaf == "none", mode == "triangle",
        mode == "texel"]
    want = tg.grad_tiles_reference((5, 0), *tabs, *cots, **kw)
    torch.cuda.synchronize()
    if mode == "texel":
        tex_grad_rule(got, want)
    elif mode == "triangle" and w.leaf == "none":
        ablated_grad_rule(got, want)
    else:
        grad_rule(got, want, True)


@pytest.mark.parametrize("walk", list(WALK_ENVS))
def test_f32_texel_forward_on_the_walks(dev, monkeypatch, walk):
    # the texel gradients' primal on a mesh scene under each walk of the
    # knobs against its plain version, bit for bit; the tensor-core leaves
    # are refused, as the differentiable render refuses them
    for k, v in WALK_ENVS[walk].items():
        monkeypatch.setenv(k, v)
    cfg = RenderConfig(width=160, height=120, samples=4)
    sc = textured_teapot(get_scene("teapot", cfg), proctex.make)
    tabs, meta, arrays, _ = grad_inputs(sc, cfg, (8, 512), dev)
    kw = dict(meta=meta, cfg=cfg, spp=4, total_samples=4, tile=(8, 512),
              tex_table=torch.from_numpy(mk.build_tex_table(arrays, meta))
              .to(dev), tex_texels=texel_params(arrays))
    if walk == "mxu":
        with pytest.raises(NotImplementedError, match="classic-traversal"):
            mk.trace_tiles((5, 0), *tabs, **kw)
        return
    before = (mk.trace_tiles.texel_launches, mk.trace_tiles.packet_launches)
    got = torch.stack(mk.trace_tiles((5, 0), *tabs, **kw))
    assert (mk.trace_tiles.texel_launches, mk.trace_tiles.packet_launches
            ) == (before[0] + 1,
                  before[1] + (mk.mesh_walk().walk != "thread"))
    want = torch.stack(mk.trace_tiles_reference((5, 0), *tabs, **kw))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("walk", ["mode2", "mode3", "mxu", "ablate2"])
def test_packet_intersect_matches_plain(dev, monkeypatch, walk):
    for k, v in WALK_ENVS[walk].items():
        monkeypatch.setenv(k, v)
    cfg = RenderConfig(width=160, height=120, samples=1)
    sc = get_scene("teapot", cfg)
    arrays, meta = sc.pack(device=dev)
    tables = mk.intersect_tables(arrays, meta, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    R = (1 << 15) + 77          # a partial block: lanes without a ray
    o = tuple((torch.rand(R, generator=gen, device=dev) - 0.5).contiguous()
              for _ in range(3))
    d = torch.randn((3, R), generator=gen, device=dev)
    d = tuple((d / torch.linalg.vector_norm(d, dim=0)).contiguous())
    before = mk.intersect_batch.packet_launches
    got = mk.intersect_batch(arrays, meta, cfg, o, d, tables=tables)
    assert mk.intersect_batch.packet_launches == before + 1
    want = mk.intersect_batch_reference(arrays, meta, cfg, o, d, tables)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0]) or walk == "mxu"
    assert torch.allclose(got[0], want[0], rtol=1e-6)
    # the winning triangle's slot, -1 off a triangle (under mxu where t is
    # bit-equal: the tensor-core leaves may round t otherwise)
    same_t = got[0] == want[0]
    assert torch.equal(got[7][same_t], want[7][same_t])
    assert bool(same_t.float().mean() > 0.99)
    # (the node walk alone tests no triangle)
    assert bool((got[7] >= 0).any()) == (walk != "ablate2")


def test_leaf_bench_and_op_rate_match_plain(dev):
    from pathtracer_tpu_torch.probes import leaf_bench, op_rate

    tables, meta, arrays = leaf_bench.teapot_leaves(dev)
    res = leaf_bench.check(leaf_bench.mesh_rays(arrays, 4096, dev), tables,
                           meta)
    assert res["prod"]["bit_equal_t"] == res["prod"]["rays"]
    assert res["prod"]["winner_equal"] == res["prod"]["rays"]
    m = res["mma"]
    assert m["t_within_1ulp"] == m["rays"]
    assert m["winner_equal"] + m["winner_differs_at_tie"] == m["rays"]
    assert res["pairs"]["within_1ulp"] >= 0.999 * res["pairs"]["pairs"]
    x = torch.rand(1000, device=dev) + 1.0
    for v in op_rate.VARIANTS:
        k, p = op_rate.run(v, x, 2), op_rate.run_plain(v, x, 2)
        assert op_rate.compare(v, k, p)["ok"], v


@pytest.mark.parametrize("walk", ["mode2", "mode3", "mxu"])
def test_packet_walks_with_one_warp_live(dev, monkeypatch, walk):
    # every slot but the first warp's of each 128-slot block on a pixel
    # that sees the light: those paths end at their first hit, and the
    # block's first warp walks on alone (under mode 2 the others only
    # cast their false octant votes). Kernel A bit for bit, Kernel B by
    # the per-slot rule
    for k, v in WALK_ENVS[walk].items():
        monkeypatch.setenv(k, v)
    tabs, meta, cfg, layout = _inputs("teapot", dev, (8, 512), width=160,
                                      height=120, samples=4,
                                      samples_per_pass=4)
    kw = dict(meta=meta, cfg=cfg, spp=4, total_samples=4, tile=(8, 512),
              **layout)
    tabs, _ = one_warp_live(tabs, kw)
    got = torch.stack(mk.trace_tiles((3, 0), *tabs, **kw))
    want = torch.stack(mk.trace_tiles_reference((3, 0), *tabs, **kw))
    torch.cuda.synchronize()
    late = (torch.arange(tabs[-2].numel(), device=dev) % 128 >= 32)
    assert got.reshape(3, -1)[:, ~late].any()
    if walk == "mxu":
        assert_slot_rule(got.cpu().numpy(), want.cpu().numpy())
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("leaf", [4, 8, 16, 32])
def test_tensor_core_leaf_check(dev, leaf):
    # Kernel B's leaf against its plain version at each leaf size (the
    # packed tiles at K <= 4, one group a tile above): t within one ulp,
    # winners equal but at exact ties, every ray x triangle t within one
    # ulp
    from pathtracer_tpu_torch.probes import leaf_bench

    tables, meta, arrays = leaf_bench.teapot_leaves(dev, leaf)
    assert meta.leaf_size == leaf
    res = leaf_bench.check(leaf_bench.mesh_rays(arrays, 4096 + 77, dev),
                           tables, meta)
    m = res["mma"]
    assert m["t_within_1ulp"] == m["rays"]
    assert m["winner_equal"] + m["winner_differs_at_tie"] == m["rays"]
    assert res["pairs"]["within_1ulp"] >= 0.999 * res["pairs"]["pairs"]
    assert res["pairs"]["hit_pairs"] > 0


@pytest.mark.parametrize("leaf", [4, 32])
def test_leaf_bench_mma_matches_plain(dev, leaf):
    # P3's `mma` variant (leaf_mma over many visits) against its plain
    # version: the same t within one ulp, the winners equal but at ties
    from pathtracer_tpu_torch.probes import leaf_bench

    tables, meta, arrays = leaf_bench.teapot_leaves(dev, leaf)
    rays = leaf_bench.mesh_rays(arrays, 2048, dev, seed=3)
    before = leaf_bench.run.launches
    kt, ks = leaf_bench.run("mma", rays, tables, meta, 7)
    assert leaf_bench.run.launches == before + 1
    pt, ps = leaf_bench.plain("mma", rays, tables, meta, 7)
    ulp = (kt.view(torch.int32).long() - pt.view(torch.int32).long()).abs()
    assert int((ulp <= 1).sum()) == kt.numel()
    same = ks.long() == ps.long()
    assert bool(((ulp == 0) | same).all())
    assert int(same.sum()) >= 0.99 * kt.numel()


def test_cli_renders_teapot_on_the_packet_walk(dev, monkeypatch, tmp_path):
    monkeypatch.setenv("PT_SUBPACKET", "3")
    monkeypatch.setenv("PT_TILE_ORDER", "subblock")
    raw = tmp_path / "t.raw"
    before = mk.trace_tiles.packet_launches
    rc = cli.main(["--scene", "teapot", "--width", "64", "--height", "48",
                   "--samples", "16", "--raw-output", str(raw),
                   "--output", str(tmp_path / "t.png")])
    assert rc == 0 and mk.trace_tiles.packet_launches == before + 2
    img = read_raw(str(raw))
    assert img.shape == (48, 64, 3) and np.isfinite(img).all()


def _flat(res):
    return [y for z in res for y in (z if isinstance(z, tuple) else (z,))]


@pytest.mark.parametrize("name,nee", [("reference", False),
                                      ("teapot", False), ("teapot", True),
                                      ("cubemap", False)])
def test_intersect_kernel_on_wavefront_bounces(dev, name, nee):
    # the wavefront's own bounced and shadow rays: K5 bit-equal to its
    # plain version at every call of a pass, and the pass's image through
    # K5 bit-equal to the pass through the plain version
    from pathtracer_tpu_torch.render import integrator, threefry

    cfg = RenderConfig(width=160, height=120, samples=8, nee=nee)
    sc = get_scene(name, cfg)
    arrays, meta = sc.pack(device=dev)
    tables = mk.intersect_tables(arrays, meta, dev)
    calls = []

    def checked(scn, meta_, cfg_, o, d, tables=None):
        got = mk.intersect_batch(scn, meta_, cfg_, o, d, tables=tables)
        want = mk.intersect_batch_reference(scn, meta_, cfg_, o, d, tables)
        for a, b in zip(_flat(got), _flat(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        calls.append(o[0].numel())
        return got

    ys, xs = np.mgrid[0:120, 0:160]
    px = torch.from_numpy(xs.ravel().astype(np.int32)).to(dev)
    py = torch.from_numpy(ys.ravel().astype(np.int32)).to(dev)
    cam = sc.camera.pack(torch.float32, dev)
    key = threefry.prng_key(3)

    def one_pass(fn):
        return torch.stack(integrator.render_pass(
            arrays, meta, cfg, cam, px, py, 0, 8, key,
            integrator.IntersectRoute(fn, tables)))

    before = mk.intersect_batch.launches
    k5 = one_pass(checked)
    assert mk.intersect_batch.launches == before + len(calls) > before + 1
    assert set(calls) == {160 * 120 * 8}
    plain = one_pass(mk.intersect_batch_reference)
    torch.cuda.synchronize()
    assert torch.equal(k5, plain)
    # the route a render takes on the card is the kernel's
    route = integrator.intersect_route(arrays, meta, cfg)
    assert route.fn is mk.intersect_batch


def test_cli_renders_the_wavefront_on_the_card(dev, tmp_path):
    raw = tmp_path / "w.raw"
    before = (mk.intersect_batch.launches, mk.trace_tiles.launches)
    rc = cli.main(["--scene", "teapot", "--backend", "wavefront", "--width",
                   "64", "--height", "48", "--samples", "8", "--nee",
                   "--raw-output", str(raw), "--output",
                   str(tmp_path / "w.png")])
    assert rc == 0 and mk.trace_tiles.launches == before[1]
    assert mk.intersect_batch.launches > before[0]
    img = read_raw(str(raw))
    assert img.shape == (48, 64, 3) and np.isfinite(img).all()
    rc = cli.main(["--scene", "reference", "--dtype", "float64", "--width",
                   "32", "--height", "24", "--samples", "2",
                   "--raw-output", str(raw), "--output",
                   str(tmp_path / "w.png")])
    assert rc == 0 and np.isfinite(read_raw(str(raw))).all()


@pytest.mark.parametrize("name", ["reference", "teapot", "textures"])
def test_wavefront_autograd_through_the_kernel(dev, name):
    # the differentiable render's fixed-trip loop takes the intersect
    # kernel on every bounce (re-attaching the winners where the rays carry
    # a gradient: `textures`' normal maps), and its gradients agree with
    # the torch walk's on the card by tests/test_torch_wavefront_grad_tex.py's
    # rule (1e-3 x max|g| a field)
    from pathtracer_tpu_torch.diff import extract_params, loss_and_grads
    from pathtracer_tpu_torch.render import integrator, threefry
    from pathtracer_tpu_torch.render.intersect import reattach_hit
    from pathtracer_tpu_torch.render.vec3 import Vec3

    cfg = RenderConfig(width=64, height=48, samples=2, samples_per_pass=2)
    sc = get_scene(name, cfg)
    arrays, meta = sc.pack(device=dev)
    cam = sc.camera.pack(torch.float32, dev)
    px, py = integrator.pixel_grid(64, 0, 48, dev)
    route = integrator.intersect_route(arrays, meta, cfg)
    assert route.fn is mk.intersect_batch
    target = Vec3.zeros((64 * 48,), torch.float32, dev)
    before = (mk.intersect_batch.launches, reattach_hit.calls)
    _, got = loss_and_grads(extract_params(arrays), arrays, meta, cfg, cam,
                            px, py, threefry.prng_key(4), 2, target,
                            route=route)
    assert mk.intersect_batch.launches == before[0] + cfg.max_bounces
    assert (reattach_hit.calls > before[1]) == (name == "textures")
    _, walk = loss_and_grads(extract_params(arrays), arrays, meta, cfg, cam,
                             px, py, threefry.prng_key(4), 2, target,
                             route=integrator.IntersectRoute())
    for k in ("color", "emission", "tri_color", "tex_planar", "tex_sphere"):
        a, b = getattr(got, k), getattr(walk, k)
        assert torch.isfinite(a).all() and torch.isfinite(b).all()
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
    if name == "teapot":
        assert bool((got.tri_color != 0).any())


@pytest.mark.parametrize("n_plain", [0, 4])
def test_wavefront_autograd_rematerialized_on_the_card(dev, n_plain):
    # `textures` with too little memory free for its bounces' intermediates
    # (integrator._free_bytes patched): the bounces past the first n_plain
    # run under torch.utils.checkpoint, so the backward relaunches K5 and
    # re-attaches once for each; the gradients agree with the plain loop's
    # on the card by the rule above (index_add_ adds in another order)
    from pathtracer_tpu_torch.diff import extract_params, loss_and_grads
    from pathtracer_tpu_torch.render import integrator, threefry
    from pathtracer_tpu_torch.render.intersect import reattach_hit
    from pathtracer_tpu_torch.render.vec3 import Vec3

    W, H, S = 64, 48, 2
    cfg = RenderConfig(width=W, height=H, samples=S, samples_per_pass=S)
    sc = get_scene("textures", cfg)
    arrays, meta = sc.pack(device=dev)
    cam = sc.camera.pack(torch.float32, dev)
    px, py = integrator.pixel_grid(W, 0, H, dev)
    route = integrator.intersect_route(arrays, meta, cfg)
    target = Vec3.zeros((W * H,), torch.float32, dev)

    def grads():
        return loss_and_grads(extract_params(arrays), arrays, meta, cfg,
                              cam, px, py, threefry.prng_key(4), S, target,
                              route=route)[1]
    before = (mk.intersect_batch.launches, reattach_hit.calls)
    with free_bytes(free_for(n_plain, W * H * S) if n_plain else 0), \
            at_backward(lambda: (mk.intersect_batch.launches,
                                 reattach_hit.calls)) as seen:
        got = grads()
    (fwd_launches, fwd_calls), = seen
    n = cfg.max_bounces
    assert fwd_launches - before[0] == n
    assert mk.intersect_batch.launches - fwd_launches == n - n_plain
    # camera rays carry no gradient: bounce 0 re-attaches nothing
    assert fwd_calls - before[1] == n - 1
    assert reattach_hit.calls - fwd_calls == n - max(n_plain, 1)
    with free_bytes(1 << 62):
        plain = grads()
    for k in ("color", "emission", "tex_planar", "tex_sphere"):
        a, b = getattr(got, k), getattr(plain, k)
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


def test_two_gloo_ranks_on_the_card(dev, tmp_path):
    # two ranks sharing the card over gloo (NCCL takes one rank a device):
    # both gather the same frame, bit for bit the frame of one process
    # playing both ranks on the card (K1 and K5 add no atomics), and the
    # CLI's image (rank 0's) is the driver's on that one-process mesh
    from _torch_dist import run_two_ranks
    from pathtracer_tpu_torch.driver import render_driver
    from pathtracer_tpu_torch.parallel import (render_sharded,
                                               render_sharded_megakernel)
    from pathtracer_tpu_torch.parallel.mesh import LogicalMesh

    outs = run_two_ranks(tmp_path, "1x2", "cuda")
    r0, r1 = (np.load(o) for o in outs)
    cfg = RenderConfig(width=32, height=24, samples=4, samples_per_pass=2)
    sc = get_scene("reference", cfg)
    arrays, meta = sc.pack(device=dev)
    mesh = LogicalMesh((1, 2))
    for k, fn in (("mega", render_sharded_megakernel),
                  ("wave", render_sharded)):
        assert np.array_equal(r0[k], r1[k])
        assert np.array_equal(r0[k], fn(arrays, meta, sc.camera, cfg, mesh))
    want, stats = render_driver(
        arrays, meta, sc.camera, cfg.replace(samples=8), checkpoint_every=2,
        checkpoint_path=str(tmp_path / "logical.ck.npz"), mesh=mesh)
    assert stats.backend == "megakernel@1x2"
    assert np.array_equal(read_raw(outs[0][:-4] + ".raw"), want)


def test_sharded_megakernel_step_on_the_card(dev):
    # make_sharded_megakernel_step over a one-process (1, 2) mesh: K6 a
    # rank on the card against the plain versions on the CPU, by the
    # gradient rule
    from pathtracer_tpu_torch.diff import make_sharded_megakernel_step
    from pathtracer_tpu_torch.parallel.mesh import LogicalMesh

    cfg = RenderConfig(width=64, height=48, samples=8, samples_per_pass=8)
    sc = get_scene("reference", cfg)
    img = np.random.default_rng(3).random((48, 64, 3)).astype(np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        arrays, meta = sc.pack(device=d)
        step, target_of = make_sharded_megakernel_step(
            arrays, meta, cfg, sc.camera, LogicalMesh((1, 2)), spp=8,
            tile=(8, 128), lr=1.0)
        before = tg.grad_tiles.launches
        c, e, loss = step(arrays.color, arrays.emission, (5, 0),
                          target_of(img))
        assert tg.grad_tiles.launches - before == (2 if d == dev else 0)
        out[d.type] = (arrays.color - c, arrays.emission - e, loss)
    grad_rule(out["cuda"][:2], out["cpu"][:2], mesh=False)
    assert abs(float(out["cuda"][2]) - float(out["cpu"][2])) <= \
        1e-5 * float(out["cpu"][2])
