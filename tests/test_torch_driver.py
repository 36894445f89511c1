"""pathtracer_tpu_torch end to end on the CPU: render_driver against the
same segments composed from the JAX megakernel (interpret mode), checkpoint
and resume, fault recovery, NEE, the .raw/.png writers and the CLI's
refusals."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import jax_fields_np, jax_pack, scene_pair
from _torch_scenes import (ATOL, MEAN_REL, RTOL, SLOT_FRAC,
                           assert_slot_rule)
import pathtracer_tpu.native as jnative
from pathtracer_tpu.io.png import write_png as jax_write_png
from pathtracer_tpu.io.raw import write_raw as jax_write_raw
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.driver import DeviceFailure, render_driver
from pathtracer_tpu_torch.io.png import write_png
from pathtracer_tpu_torch.io.raw import read_raw, write_raw

torch.set_num_threads(2)

CPU = torch.device("cpu")
CFG = dict(width=32, height=24, samples=8, samples_per_pass=2)
# teapot: two 8-spp segments (the mesh default of PT_SEG_SPP)
MESH_CFG = dict(width=32, height=24, samples=16, samples_per_pass=8)


def _render(monkeypatch, name="reference", nee=False, **driver_kw):
    monkeypatch.setenv("PT_SEG_SPP", "4")     # 2 segments of 2 chunks
    _, _, ts, tc = scene_pair(name, nee=nee, **CFG)
    arrays, meta = ts.pack(device=CPU)
    return render_driver(arrays, meta, ts.camera, tc, **driver_kw)


def _jax_segments(order, name="reference"):
    """`name` at CFG as two 4-spp segments of the JAX megakernel
    (interpret mode), seeded as pathtracer_tpu.driver seeds them
    (driver.py:256-270), on tile order `order`: [H, W, 3]."""
    js, jc, ts, _ = scene_pair(name, **CFG)
    ja, jm = jax_pack(js, ts)
    S, L = pk.default_tile(jm)
    xs, ys, pid = pk.tile_pixel_layout(32, 24, S, L, order=order)
    tabs = [jnp.asarray(t) for t in (
        pk.build_camera_vec(js.camera), pk.build_scene_table(ja, jm),
        *pk.build_mesh_tables(ja, jm), xs, ys)]
    acc = 0.0
    for c0 in (0, 2):
        seed = jnp.asarray([jc.seed * 7919 + c0 + 1, c0 * 2], jnp.int32)
        r, g, b = pk.trace_tiles(seed, *tabs, meta=jm, cfg=jc, spp=4,
                                 total_samples=8, tile=(S, L),
                                 interpret=True)
        acc = acc + jnp.stack([r.reshape(-1), g.reshape(-1),
                               b.reshape(-1)], axis=-1)
    acc = np.asarray(acc).astype(np.float64)
    want = (pk.untile_image(acc, pid, 32, 24) / 8.0).astype(np.float32)
    return want.reshape(24, 32, 3)


def test_driver_matches_jax_segments(monkeypatch):
    img, stats = _render(monkeypatch)
    assert stats.segments == 2 and stats.samples == 32 * 24 * 8
    assert stats.backend == "megakernel"
    want = _jax_segments("linear")
    assert_slot_rule(np.moveaxis(img, -1, 0), np.moveaxis(want, -1, 0))
    # Cornell walls: red left, blue right
    left, right = img[:, :3].mean((0, 1)), img[:, -3:].mean((0, 1))
    assert left[0] > left[2] and right[2] > right[0]


def test_driver_textures_matches_jax_segments(monkeypatch):
    # the textured path end to end: the texel pool and texture table go
    # through the driver to the kernel's plain version. The JAX segments
    # are held by the textured kernel rule (tests/test_torch_tex_kernel.py):
    # XLA:CPU's fused multiply-adds move a computed texel across an rgb8
    # rounding edge now and then
    img, stats = _render(monkeypatch, "textures")
    assert stats.segments == 2 and stats.samples == 32 * 24 * 8
    want = _jax_segments("linear", "textures")
    d = np.abs(img - want)
    near = np.isclose(img, want, atol=ATOL, rtol=RTOL) | (d <= 2.5 / 255)
    assert np.isfinite(img).all() and near.mean() >= SLOT_FRAC
    rel = np.abs(img.mean((0, 1)) - want.mean((0, 1))) / want.mean((0, 1))
    assert rel.max() < MEAN_REL


def test_driver_block_order_matches_jax_segments(monkeypatch):
    # PT_TILE_ORDER=block renders pixels in square blocks: other slots,
    # so another random stream per pixel, and a checkpoint layout of its own
    monkeypatch.setenv("PT_TILE_ORDER", "block")
    img, _ = _render(monkeypatch)
    want = _jax_segments("block")
    assert_slot_rule(np.moveaxis(img, -1, 0), np.moveaxis(want, -1, 0))
    monkeypatch.delenv("PT_TILE_ORDER")
    assert not np.array_equal(img, _render(monkeypatch)[0])


@pytest.mark.parametrize("env", [{"PT_TILE_ORDER": "subblock"},
                                 {"PT_TILE_ORDER": "rowblock"}])
def test_driver_refuses_unported_layouts(monkeypatch, env):
    # the tile orders of the TPU's sub-packet gating and MXU leaf machine
    # are ported: their slots, so their random streams, are the JAX
    # package's
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    img, _ = _render(monkeypatch)
    want = _jax_segments(env["PT_TILE_ORDER"])
    assert_slot_rule(np.moveaxis(img, -1, 0), np.moveaxis(want, -1, 0))


def test_torch_checkpoint_resume_bit_identical(monkeypatch, tmp_path):
    # the checkpoint interval sets the segments (the random stream) and
    # the host flushes (the f64 summation order)
    full, _ = _render(monkeypatch, "transparency", checkpoint_every=1,
                      checkpoint_path=str(tmp_path / "full.npz"))
    ck = str(tmp_path / "ck.npz")
    # a persistent outage after chunk 2 kills the first run ...
    monkeypatch.setenv("PT_FAULT_INJECT", "2")
    monkeypatch.setenv("PT_FAULT_COUNT", "9")
    with pytest.raises(DeviceFailure):
        _render(monkeypatch, "transparency", checkpoint_path=ck,
                checkpoint_every=1)
    with np.load(ck) as z:
        assert int(z["chunks_done"]) == 2
    # ... and the resumed run finishes it bit for bit
    monkeypatch.delenv("PT_FAULT_INJECT")
    img, _ = _render(monkeypatch, "transparency", checkpoint_path=ck,
                     checkpoint_every=1, resume=True)
    assert np.array_equal(img, full)
    # a checkpoint written for another config is refused
    with pytest.raises(ValueError, match="checkpoint_every"):
        _render(monkeypatch, "transparency", checkpoint_path=ck,
                checkpoint_every=2, resume=True)


def _teapot_segments(monkeypatch, nee: bool):
    """`teapot` at MESH_CFG through render_driver and as the same segments
    of the JAX megakernel (interpret mode): the mesh layout of both
    drivers, tile (8, 512), block order, 4 sample replicas on the lane
    chunks, segments of 8 spp. Returns (port image, its stats, JAX
    image)."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    js, jc, ts, tc = scene_pair("teapot", nee=nee, **MESH_CFG)
    arrays, meta = ts.pack(device=CPU)
    img, stats = render_driver(arrays, meta, ts.camera, tc)
    ja, jm = jax_pack(js, ts)
    # the JAX NumPy path packs NaN group bounds for a parsed model (ROADMAP
    # queue 3): hand its kernel the port's, the model's vertex bounds
    fields = dict(jax_fields_np(ja), bb_min=arrays.bb_min.numpy(),
                  bb_max=arrays.bb_max.numpy())
    ja = ja._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    S, L = pk.default_tile(jm)
    axis = pk.default_pack_axis(jm)
    pack = pk.clamp_pack(pk.default_pack(jm, 8), S, L, axis)
    assert (S, L, pack, axis) == (8, 512, 4, "chunk")
    xs, ys, pid = pk.tile_pixel_layout(32, 24, S, L,
                                       order=pk.default_order(jm),
                                       spp_pack=pack, pack_axis=axis)
    tabs = [jnp.asarray(t) for t in (
        pk.build_camera_vec(js.camera), pk.build_scene_table(ja, jm),
        *pk.build_mesh_tables(ja, jm), xs, ys)]
    acc = 0.0
    for c0 in (0, 1):
        seed = jnp.asarray([jc.seed * 7919 + c0 + 1, c0 * 8], jnp.int32)
        r, g, b = pk.trace_tiles(seed, *tabs, meta=jm, cfg=jc, spp=8,
                                 total_samples=16, tile=(S, L),
                                 spp_pack=pack, pack_axis=axis,
                                 interpret=True)
        acc = acc + jnp.stack([r.reshape(-1), g.reshape(-1),
                               b.reshape(-1)], axis=-1)
    acc = np.asarray(acc).astype(np.float64)
    want = (pk.untile_image(acc, pid, 32, 24) / 16.0).astype(np.float32)
    return img, stats, want.reshape(24, 32, 3)


def test_driver_teapot_matches_jax_segments(monkeypatch):
    img, stats, want = _teapot_segments(monkeypatch, nee=False)
    assert stats.segments == 2 and stats.samples == 32 * 24 * 16
    assert_slot_rule(np.moveaxis(img, -1, 0), np.moveaxis(want, -1, 0))
    left, right = img[:, :3].mean((0, 1)), img[:, -3:].mean((0, 1))
    assert left[0] > left[2] and right[2] > right[0]


def test_driver_teapot_nee_matches_jax_segments(monkeypatch):
    # `teapot --nee`: the driver hands cfg.nee to every segment, whose
    # shadow rays walk the mesh
    img, stats, want = _teapot_segments(monkeypatch, nee=True)
    assert stats.segments == 2 and stats.samples == 32 * 24 * 16
    assert_slot_rule(np.moveaxis(img, -1, 0), np.moveaxis(want, -1, 0))
    left, right = img[:, :3].mean((0, 1)), img[:, -3:].mean((0, 1))
    assert left[0] > left[2] and right[2] > right[0]


def test_driver_renders_nee(monkeypatch):
    # cfg.nee through render_driver: the same segments, brighter by the
    # shadow rays' direct light
    img, stats = _render(monkeypatch, nee=True)
    off, _ = _render(monkeypatch)
    assert stats.segments == 2 and np.isfinite(img).all()
    assert img.mean() > 1.2 * off.mean()


def test_torch_checkpoint_resume_teapot_bit_identical(monkeypatch,
                                                      tmp_path):
    _, _, ts, tc = scene_pair("teapot", **MESH_CFG)
    arrays, meta = ts.pack(device=CPU)

    def render(**kw):
        return render_driver(arrays, meta, ts.camera, tc,
                             checkpoint_every=1, **kw)[0]

    full = render(checkpoint_path=str(tmp_path / "full.npz"))
    ck = str(tmp_path / "ck.npz")
    # a persistent outage after chunk 1 kills the first run ...
    monkeypatch.setenv("PT_FAULT_INJECT", "1")
    monkeypatch.setenv("PT_FAULT_COUNT", "9")
    with pytest.raises(DeviceFailure):
        render(checkpoint_path=ck)
    monkeypatch.delenv("PT_FAULT_INJECT")
    with np.load(ck) as z:
        assert int(z["chunks_done"]) == 1
        assert json.loads(str(z["meta"]))["layout"] == \
            "tile8x512:block:pack4chunk"
    # ... and the resumed run finishes it bit for bit
    assert np.array_equal(render(checkpoint_path=ck, resume=True), full)


def test_torch_fault_recovery_identical_output(monkeypatch):
    full, _ = _render(monkeypatch)
    monkeypatch.setenv("PT_FAULT_INJECT", "2")
    img, stats = _render(monkeypatch)
    assert stats.recoveries == 1
    assert np.array_equal(img, full)


@pytest.mark.parametrize("bad,item", [
    (dict(backend="wavefront"), "item 13"),
    (dict(dtype="float64"), "item 13"),
])
def test_driver_refuses_unported_configs(bad, item):
    # the wavefront backend and f64 render (tests/test_torch_wavefront_
    # render.py); a device mesh, once refused as `item` (ROADMAP queue 1),
    # now takes them too: the driver under a one-rank mesh is the sharded
    # wavefront's estimator bit for bit (tests/test_torch_dist_*.py hold
    # larger meshes)
    from pathtracer_tpu_torch.parallel import render_sharded
    from pathtracer_tpu_torch.parallel.mesh import LogicalMesh

    _, _, ts, tc = scene_pair("reference", **CFG)
    cfg = tc.replace(**bad)
    arrays, meta = ts.pack(device=CPU, dtype=getattr(torch, cfg.dtype))
    img, stats = render_driver(arrays, meta, ts.camera, cfg,
                               mesh=LogicalMesh((1, 1)))
    assert stats.backend == "wavefront@1x1" and item not in stats.backend
    assert np.array_equal(img, render_sharded(arrays, meta, ts.camera, cfg,
                                              LogicalMesh((1, 1))))


def test_raw_and_png_match_jax_writers(tmp_path):
    img = np.random.default_rng(0).uniform(
        -0.2, 1.3, (7, 11, 3)).astype(np.float32)
    write_raw(str(tmp_path / "t.raw"), img)
    jax_write_raw(str(tmp_path / "j.raw"), img)
    assert (tmp_path / "t.raw").read_bytes() == \
        (tmp_path / "j.raw").read_bytes()
    assert np.array_equal(read_raw(str(tmp_path / "t.raw")), img)
    write_png(str(tmp_path / "t.png"), img)
    jax_write_png(str(tmp_path / "j.png"), img)
    with Image.open(tmp_path / "t.png") as a, \
            Image.open(tmp_path / "j.png") as b:
        assert a.mode == "RGB" and a.size == (11, 7)
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("flags,item", [
    (["--distributed"], "item 13"),
    (["--mesh", "1x1"], "item 13"),
])
def test_cli_refuses_unported_flags(flags, item, capsys, monkeypatch,
                                    tmp_path):
    # the mesh flags, once refused as `item`, are taken: without a card and
    # without --device cpu the CLI stops at the device check (1), and with
    # --device cpu it renders a world of one rank (tests/test_torch_dist_
    # driver.py holds the mesh itself)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = tmp_path / "x.raw"
    out = ["--width", "8", "--height", "6", "--raw-output", str(raw),
           "--output", str(tmp_path / "x.png")]
    assert cli.main(flags + out) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err and item not in err and not raw.exists()
    assert cli.main(flags + out + ["--device", "cpu"]) == 0
    assert read_raw(str(raw)).shape == (6, 8, 3)


@pytest.mark.parametrize("flags", [
    ["--backend", "wavefront"], ["--dtype", "float64"],
    ["--debug-ray", "3"], ["--profile", "PROF"],
    ["--backend", "wavefront", "--nee", "--scene", "teapot"],
])
def test_cli_takes_the_wavefront_flags(flags, tmp_path, capsys, monkeypatch):
    # lifted: each renders on --device cpu; without a card and without
    # --device cpu the CLI stops at the device check (1)
    flags = [str(tmp_path / "prof") if f == "PROF" else f for f in flags]
    raw, metrics = tmp_path / "x.raw", tmp_path / "m.json"
    rc = cli.main(flags + ["--device", "cpu", "--width", "8", "--height",
                           "6", "--samples", "2", "--raw-output", str(raw),
                           "--output", str(tmp_path / "x.png"),
                           "--metrics-json", str(metrics)])
    out = capsys.readouterr()
    assert rc == 0, out.err
    img = read_raw(str(raw))
    assert img.shape == (6, 8, 3) and np.isfinite(img).all()
    rec = json.loads(metrics.read_text())
    wavefront = "--profile" not in flags
    assert rec["backend"] == ("wavefront" if wavefront else "megakernel")
    assert rec["device"] == "cpu"
    if "--debug-ray" in flags:
        assert "bounce 0 ray 3: o=(" in out.out
    if "--profile" in flags:
        assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(flags + ["--raw-output", str(raw)]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_takes_nee(monkeypatch, tmp_path, capsys):
    # --nee is no longer refused: without a card the CLI stops at the
    # device check (1), not at the unported-flag check (2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["--nee", "--width", "8", "--height", "6", "--raw-output",
                   str(tmp_path / "x.raw"), "--output",
                   str(tmp_path / "x.png")])
    assert rc == 1 and "no CUDA device" in capsys.readouterr().err


def test_cli_lists_scenes_and_needs_a_card(monkeypatch, tmp_path, capsys):
    assert cli.main(["--list-scenes"]) == 0
    out = capsys.readouterr().out
    assert "reference" in out and "transparency_f_light" in out
    assert "teapot" in out and "gopher-window" in out
    assert "textures" in out and "cubemap" in out and "envmap-file" in out
    # no fallback to the CPU: without a card the CLI renders nothing
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = tmp_path / "x.raw"
    rc = cli.main(["--width", "8", "--height", "6", "--raw-output",
                   str(raw), "--output", str(tmp_path / "x.png")])
    assert rc == 1 and not raw.exists()
    assert "no CUDA device" in capsys.readouterr().err


def test_metrics_json_fields():
    from pathtracer_tpu_torch.driver import RenderStats

    s = RenderStats(wall_s=2.0, samples=4_000_000, backend="megakernel",
                    segments=3)
    rec = json.loads(s.to_json(scene="reference"))
    assert rec["msamples_per_sec"] == 2.0 and rec["segments"] == 3
    assert rec["scene"] == "reference"
    assert not os.environ.get("PT_FAULT_INJECT")
