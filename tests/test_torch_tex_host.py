"""pathtracer_tpu_torch's texture host layer against pathtracer_tpu: the
procedural programs, the texture generators and loader, the rgb8 texel
pool, the per-object texture fields and records of SceneMeta (staging
markers included) and the tile they select must be exactly equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import jax_fields_np, jax_twin, scene_pair
from _torch_scenes import TEX_SCENES
from pathtracer_tpu import assets as jassets
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu.render import proctex as jpt
from pathtracer_tpu_torch import assets as tassets
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.render import proctex as tpt
from pathtracer_tpu_torch.scene import from_jax_scene

torch.set_num_threads(2)

CPU = torch.device("cpu")
# each program at a small size, with the parameters the scenes use
PROGRAMS = {
    "checker": ((8, (0.9, 0.9, 0.9), (0.2, 0.2, 0.2)), 48, 64),
    "squares": ((7,), 64, 64),
    "squares_nm": ((), 64, 48),
    "cobblestone": ((11, 13), 96, 64),
    "floorboards": ((17,), 64, 64),
    "planet": ((23,), 64, 128),
    "jupiter": ((31,), 64, 128),
    "sky": ((), 64, 128),
    "cube_cross": ((16,), 48, 64),
}


def test_program_table_is_the_jax_packages():
    assert sorted(tpt.PROGRAMS) == sorted(jpt.PROGRAMS) == sorted(PROGRAMS)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_proctex_image_bit_equal_jax(name):
    params, h, w = PROGRAMS[name]
    got = tpt.make((name, params), h, w)
    want = jpt.eval_image((name, params), h, w)
    assert got.dtype == np.float32 and got.proc == (name, params)
    assert np.array_equal(np.asarray(got), want)
    assert np.array_equal(tpt.quantize8(np.asarray(got)),
                          jpt.quantize8(np, want))


def test_proctex_primitives_bit_equal_jax():
    rng = np.random.default_rng(0)
    ix, iy = (rng.integers(0, 1 << 20, 4096).astype(np.uint32)
              for _ in range(2))
    assert np.array_equal(tpt.hash01(ix, iy, 5), jpt.hash01(np, ix, iy, 5))
    fx, fy = (rng.uniform(0, 200, 4096).astype(np.float32) for _ in range(2))
    assert np.array_equal(tpt.value_noise(fx, fy, 12, 200, 200, 3),
                          jpt.value_noise(np, fx, fy, 12, 200, 200, 3))


@pytest.mark.parametrize("file", [
    "concrete_squares.png", "concrete_squares_nm2.png",
    "seamless-cobblestone-texture.jpg", "floor_boards.png", "planet.png",
    "jupiter2_6k_contrast.png", "shrine_cubemap.jpeg", "no-such-image.png",
])
def test_load_texture_equal_jax(file):
    got, want = tassets.load_texture(file), jassets.load_texture(file)
    assert got.proc == want.proc and np.array_equal(got, want)


def test_load_texture_reads_a_real_file(monkeypatch, tmp_path):
    # a real image under PT_ASSETS is decoded (with Pillow), not generated
    rng = np.random.default_rng(1)
    Image.fromarray(rng.integers(0, 256, (6, 10, 3), dtype=np.uint8)).save(
        tmp_path / "planet.png")
    monkeypatch.setenv("PT_ASSETS", str(tmp_path))
    got, want = tassets.load_texture("planet.png"), jassets.load_texture(
        "planet.png")
    assert type(got) is np.ndarray and got.shape == (6, 10, 3)
    assert np.array_equal(got, want)


def _check_pack(name):
    # jax_twin: the JAX half on its NumPy path whether or not the JAX
    # native scene core loaded here, its group rows held to the port's
    # (a NaN row there only where the port's leaves an empty child empty)
    _, _, ja, jm, ts, _ = jax_twin(name, width=32, height=24, samples=4)
    ta, tm = ts.pack(device=CPU)
    jf = jax_fields_np(ja)
    for k, v in ta._asdict().items():
        if k == "tex_staged":    # the JAX package's staged atlas: not built
            assert v.shape == (8, 128) and not v.any()
            continue
        assert v.dtype == getattr(torch, str(jf[k].dtype)) or k.endswith(
            "u32"), k
        assert np.array_equal(v.numpy().view(jf[k].dtype), jf[k]), k
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert mk.default_tile(tm) == pk.default_tile(jm)
    assert mk.staged_lanes(tm) == pk.staged_lanes(jm)
    assert mk.textures_computable(tm) == pk.textures_computable(jm)
    # the JAX kernel takes only computable textures; this one every texture
    assert mk.supports_scene(tm)
    assert pk.supports_scene(jm) == pk.textures_computable(jm)
    return ta, tm


@pytest.mark.parametrize("name", TEX_SCENES)
def test_tex_pack_equal_jax(name):
    ta, tm = _check_pack(name)
    # the texture table: each record's flag, pool (base, w, h) and scale
    tab = mk.build_tex_table(ta, tm)
    assert tab.shape == (len(tm.obj_types), 12) and tab.dtype == np.float32
    for col, recs, (b, w, h) in (
            (0, tm.obj_tex, (ta.tex_base, ta.tex_w, ta.tex_h)),
            (6, tm.obj_tex_nm, (ta.tex_nm_base, ta.tex_nm_w, ta.tex_nm_h))):
        assert (tab[:, col] > 0.5).sum() == len(recs)
        for slot, _desc, _w, _h, sx, sy in recs:
            assert list(tab[slot, col:col + 6]) == [
                1.0, b[slot], w[slot], h[slot], np.float32(sx),
                np.float32(sy)]
            assert tab[slot, col + 1] + tab[slot, col + 2] * tab[
                slot, col + 3] <= ta.tex_pool_u32.numel()


@pytest.mark.parametrize("name,env", [
    ("textures-file", {"PT_TEX_STAGE": "0"}),
    ("envmap-file", {"PT_TEX_MIP": "0"}),
    ("textures-file", {"PT_TEX_STAGE_LANES": "1024"}),
    ("envmap-file", {"PT_TEX_MIP_AREA": str(64 * 64)}),
    ("textures-train", {"PT_TEX_STAGE_AREA": str(128 * 128)}),
])
def test_tex_pack_knobs_equal_jax(monkeypatch, name, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _, tm = _check_pack(name)
    if env.get("PT_TEX_STAGE") == "0" or env.get("PT_TEX_MIP") == "0":
        # nothing staged: the JAX package renders such a scene on its
        # wavefront path; the tile goes back to the primitive one
        assert mk.staged_lanes(tm) == 0 and not mk.textures_computable(tm)
        assert mk.default_tile(tm) == (64, 256)


def test_tex_fetch_quad_raises(monkeypatch):
    # PT_TEX_FETCH=quad is ported (it raised before the wavefront path
    # was): the quad pool holds each texel's footprint, and the one-row
    # fetch equals the four taps bit for bit, in f32 and f64
    from pathtracer_tpu_torch.render.uv import sample_texture_pool

    monkeypatch.setenv("PT_TEX_FETCH", "quad")
    _, _, ts, _ = scene_pair("envmap", width=8, height=6)
    ta, tm = ts.pack(device=CPU)
    quad = ta.tex_pool_quad_u32
    assert quad.shape == (ta.tex_pool_u32.shape[0], 4)
    assert torch.equal(quad[:, 0].view(torch.int32),
                       ta.tex_pool_u32.view(torch.int32))
    slot = tm.obj_tex[0][0]
    rng = np.random.default_rng(5)
    for dt in (torch.float32, torch.float64):
        u, v = (torch.from_numpy(rng.uniform(-3, 3, 4096)).to(dt)
                for _ in range(2))
        b, w, h = (getattr(ta, f)[slot].to(dt).expand(4096)
                   for f in ("tex_base", "tex_w", "tex_h"))
        one = sample_texture_pool(ta.tex_pool_u32, b, w, h, u, v, quad)
        four = sample_texture_pool(ta.tex_pool_u32, b, w, h, u, v)
        for x, y in zip(one, four):
            assert x.dtype == dt and torch.equal(x, y)


def test_from_jax_scene_textured_round_trip():
    # the JAX pack of a scene with staged textures carries over field for
    # field (the staged atlas becomes the placeholder) and renders as the
    # port's own pack does
    js, _, ts, tc = scene_pair("textures-file", width=16, height=8,
                               samples=2, samples_per_pass=2)
    ja, jm = js.pack(dtype=jnp.float32)
    assert pk.staged_lanes(jm) and np.asarray(ja.tex_staged).any()
    fa, fm = from_jax_scene(jax_fields_np(ja), jm, CPU)
    ta, tm = ts.pack(device=CPU)
    assert fm == tm
    for k, v in ta._asdict().items():
        assert torch.equal(getattr(fa, k), v), k
    img = [mk.render_megakernel(a, m, ts.camera, tc)
           for a, m in ((fa, fm), (ta, tm))]
    assert np.isfinite(img[0]).all() and np.array_equal(*img)


def test_rgb8_decode_differs_from_the_staged_atlas():
    # The pool (and the JAX kernel's computed texels) decode a byte as
    # q * f32(1/255); the JAX package's staged atlas as f32(q) / f32(255)
    # (its scene/pack.py:336-337). They differ by one ulp on 126 of the
    # 256 byte values, so staged texels are not the pool's bit for bit.
    # The port decodes the pool's way.
    q = np.arange(256, dtype=np.float32)
    pool = q * np.float32(1.0 / 255.0)
    staged = q / np.float32(255.0)
    diff = pool != staged
    assert diff.sum() == 126
    assert np.abs(pool - staged).max() <= np.spacing(np.float32(1.0))
    # sample_pool at the texel centers of a 256x1 ramp returns the pool's
    ramp = torch.from_numpy(np.arange(256, dtype=np.int32) * 0x010101)
    u = torch.from_numpy((np.arange(256, dtype=np.float32) + 0.5) / 256)
    f = lambda x: torch.full_like(u, float(x))
    got = mk.sample_pool(ramp, f(0), f(256), f(1), u, f(0.5))
    for c in got:
        assert np.array_equal(c.numpy(), pool)
