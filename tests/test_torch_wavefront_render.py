"""The wavefront integrator of pathtracer_tpu_torch (render/integrator.py)
and its driver segments against the JAX package's on the CPU, on the same
scenes, seeds and threefry streams, so pixel by pixel.

f32 (`pixel_rule`): every pixel within PIXEL_ATOL = 1e-5 of the JAX
wavefront on every channel, for `reference`, `teapot` (the JAX side on
its NumPy scene-core, as the mesh parity tests build it), NEE, the row
blocks and the driver's segments; measured, the worst pixel 3.8e-6
(`teapot --nee`). The goldens of tests/test_golden.py: `reference` and
`transparency` by the same rule (measured 2.4e-7), `textures` every pixel
within TEXTURES_GOLDEN_ATOL = 1e-4 (measured 2.9e-5, on 3 of 768 pixels
above 1e-5: the golden's texels were computed by the JAX package under
jit), and all three by test_golden.py's own rule, 99% of the pixels
within 2e-5.

`cubemap` alone takes a looser rule (`cubemap_rule`): at least 98% of the
pixels within 1e-3, every pixel within one texel step (1/255), the channel
means within 1e-4; measured 98.05%, the worst pixel 1.9e-3, the means
4.3e-5. Its cause: XLA:CPU contracts the cube map's UV multiply-adds into
FMAs under jit, which moves some of its texel fetches by up to a texel
step (eagerly, the port's fetch and the JAX package's computed texels
agree: tests/test_torch_wavefront_ops.py).

The intersect kernel's route (its plain version, forced) against the
torch walk: every ray's object the same but for counted exact ties, and
every pixel without a tie within PIXEL_ATOL (measured over all pixels,
ties included: 3.6e-7). f64 renders must match the JAX f64 render within
F64_ATOL = 1e-6 on every pixel (measured: equal). `measure()` (run this
file) prints the f32 measurements.
"""
import os
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu.native as jnative
from _torch_parity import jax_pack, scene_pair
from pathtracer_tpu.driver import render_driver as jax_driver
from pathtracer_tpu.render.integrator import render as jax_render
from pathtracer_tpu_torch.driver import DeviceFailure, render_driver
from pathtracer_tpu_torch.render import integrator, threefry
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.render.intersect import intersect_scene
from pathtracer_tpu_torch.render.vec3 import Vec3

torch.set_num_threads(2)

CPU = torch.device("cpu")
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
PIXEL_ATOL = 1e-5
TEXTURES_GOLDEN_ATOL = 1e-4
GOLDEN_ATOL, GOLDEN_SHARE = 2e-5, 0.99
CUBEMAP_SHARE, CUBEMAP_ATOL, CUBEMAP_MAX, CUBEMAP_MEAN = (0.98, 1e-3,
                                                          1 / 255, 1e-4)
F64_ATOL = 1e-6
# tests/test_golden.py's configurations
GOLDEN_CFG = {
    "reference": dict(width=32, height=24, samples=8, samples_per_pass=4,
                      seed=7),
    "textures": dict(width=32, height=24, samples=4, samples_per_pass=4,
                     seed=11),
    "transparency": dict(width=32, height=24, samples=4, samples_per_pass=4,
                         seed=11),
}


def pixel_diff(got, want):
    """The largest channel difference of each pixel."""
    assert got.shape == want.shape and np.isfinite(got).all()
    return np.abs(got - want).max(-1)


def pixel_rule(got, want, atol=PIXEL_ATOL):
    d = pixel_diff(got, want)
    assert d.max() <= atol, (d.max(), int((d > atol).sum()))


def cubemap_rule(got, want):
    d = pixel_diff(got, want)
    assert (d <= CUBEMAP_ATOL).mean() >= CUBEMAP_SHARE, (
        (d <= CUBEMAP_ATOL).mean())
    assert d.max() <= CUBEMAP_MAX, d.max()
    assert np.abs(got.mean((0, 1)) - want.mean((0, 1))).max() <= CUBEMAP_MEAN


def pair(name, **cfg):
    """(JAX arrays, meta, scene, cfg, port arrays, meta, scene, cfg)."""
    dt = cfg.get("dtype", "float32")
    with mock.patch.object(jnative, "available", lambda: False):
        js, jc, ts, tc = scene_pair(name, **cfg)
        ja, jm = jax_pack(js, ts, dtype=getattr(jnp, dt))
    ta, tm = ts.pack(device=CPU, dtype=getattr(torch, dt))
    return ja, jm, js, jc, ta, tm, ts, tc


def port_render(name, **cfg):
    _, _, _, _, ta, tm, ts, tc = pair(name, **cfg)
    return integrator.render(ta, tm, ts.camera, tc)


@pytest.mark.parametrize("name", sorted(GOLDEN_CFG))
def test_render_matches_the_goldens(name):
    with np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) as z:
        want = z["img"]
    got = port_render(name, **GOLDEN_CFG[name])
    assert got.dtype == np.float32
    pixel_rule(got, want,
               TEXTURES_GOLDEN_ATOL if name == "textures" else PIXEL_ATOL)
    assert (pixel_diff(got, want) <= GOLDEN_ATOL).mean() >= GOLDEN_SHARE


@pytest.mark.parametrize("name,nee,spp", [("reference", True, 8),
                                          ("teapot", True, 4),
                                          ("cubemap", False, 4)])
def test_render_matches_jax_wavefront(name, nee, spp):
    ja, jm, js, jc, ta, tm, ts, tc = pair(
        name, width=32, height=24, samples=spp, samples_per_pass=4, seed=7,
        nee=nee)
    want = jax_render(ja, jm, js.camera, jc)
    got = integrator.render(ta, tm, ts.camera, tc)
    (cubemap_rule if name == "cubemap" else pixel_rule)(got, want)
    if nee:
        # next-event estimation adds light: the render without it is darker
        off = integrator.render(ta, tm, ts.camera, tc.replace(nee=False))
        assert off.mean() < got.mean()


@pytest.mark.parametrize("name", ["reference", "textures"])
def test_f64_render_matches_jax_f64(name):
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        ja, jm, js, jc, ta, tm, ts, tc = pair(
            name, width=24, height=18, samples=8, samples_per_pass=4, seed=3,
            dtype="float64")
        assert ta.color.dtype == torch.float64
        want = jax_render(ja, jm, js.camera, jc)
    finally:
        jax.config.update("jax_enable_x64", x64)
    got = integrator.render(ta, tm, ts.camera, tc)
    assert np.abs(got - want).max() <= F64_ATOL


@pytest.mark.parametrize("name,nee", [("reference", True), ("teapot", True),
                                      ("textures", False)])
def test_kernel_route_render_matches_the_walk(name, nee):
    # the intersect kernel's route (its plain version, forced on the CPU)
    # against the torch walk, NEE's shadow rays included: each call's rays
    # go through both, the objects must agree but on exact ties (counted),
    # and the pixels none of whose rays tied must agree
    _, _, _, _, ta, tm, ts, tc = pair(name, width=32, height=24, samples=4,
                                      samples_per_pass=4, seed=5, nee=nee)
    walk = integrator.render(ta, tm, ts.camera, tc)
    tied = np.zeros(ts.camera.height * ts.camera.width, bool)
    calls = []

    def plain(scn, meta, cfg, o, d, tables=None):
        got = mk.intersect_batch_reference(scn, meta, cfg, o, d, tables)
        w = intersect_scene(scn, meta, Vec3(*o), Vec3(*d), cfg.epsilon,
                            cfg.t_max)
        differ = (got[1] != w.obj_idx).numpy()
        ties = differ & (got[0] == w.t).numpy()
        assert not (differ & ~ties).any(), int((differ & ~ties).sum())
        # a pass's rays are its pixels' samples, tc.samples_per_pass each
        tied[np.flatnonzero(ties) // tc.samples_per_pass] = True
        calls.append(len(ties))
        return got

    route = integrator.intersect_route(ta, tm, tc, fn=plain)
    k5 = integrator.render(ta, tm, ts.camera, tc, route=route)
    assert calls and set(calls) == {tied.size * tc.samples_per_pass}
    untied = ~tied.reshape(walk.shape[:2])
    pixel_rule(k5[untied], walk[untied])
    # f64 keeps the walk, and a CPU render; the fixed-trip loop (the
    # differentiable path's) takes the kernel on the card too
    assert integrator.intersect_route(ta, tm, tc).fn is None
    assert integrator.kernel_route_applies(
        tm, tc.replace(early_exit=False), torch.device("cuda"))
    assert not integrator.kernel_route_applies(
        tm, tc.replace(dtype="float64"), torch.device("cuda"))
    assert integrator.kernel_route_applies(tm, tc, torch.device("cuda"))


def test_fixed_trip_loop_and_row_blocks_match_jax():
    # early_exit=False runs every bounce with the dead rays masked: the same
    # image; rows_per_pass splits the image under fold_in(key, first row)
    ja, jm, js, jc, ta, tm, ts, tc = pair(
        "reference", width=24, height=10, samples=4, samples_per_pass=2,
        seed=9, rows_per_pass=4)
    want = jax_render(ja, jm, js.camera, jc)
    got = integrator.render(ta, tm, ts.camera, tc)
    pixel_rule(got, want)
    fixed = integrator.render(ta, tm, ts.camera, tc.replace(early_exit=False))
    assert np.array_equal(fixed, got)


_PROBE = re.compile(r"bounce (\d+) ray (\d+): o=\(([^)]*)\) d=\(([^)]*)\) "
                    r"mask=\(([^)]*)\) accum=\(([^)]*)\) alive=(True|False)")


def _probes(text):
    out = []
    for m in _PROBE.finditer(text):
        nums = [float(x) for g in m.groups()[2:6] for x in g.split(",")]
        out.append((int(m.group(1)), int(m.group(2)), nums, m.group(7)))
    return out


def test_debug_ray_lines_match_jax(capfd):
    ja, jm, js, jc, ta, tm, ts, tc = pair(
        "reference", width=16, height=12, samples=2, samples_per_pass=2,
        seed=4, debug_ray=37)
    jax_render(ja, jm, js.camera, jc)
    jax.effects_barrier()
    want = _probes(capfd.readouterr().out)
    integrator.render(ta, tm, ts.camera, tc)
    got = _probes(capfd.readouterr().out)
    assert len(got) == len(want) >= 2
    for (gb, gi, gn, ga), (wb, wi, wn, wa) in zip(got, want):
        assert (gb, gi, ga) == (wb, wi, wa)
        # five or four decimals printed: the last may round the other way
        assert np.abs(np.asarray(gn) - np.asarray(wn)).max() <= 1.01e-4


def _driver_pair(monkeypatch, **kw):
    monkeypatch.setenv("PT_SEG_SPP", "4")     # 2 segments of 2 chunks
    cfg = dict(width=24, height=10, samples=8, samples_per_pass=2, seed=3,
               backend="wavefront", **kw)
    return pair("reference", **cfg)


@pytest.mark.parametrize("rows", [0, 4])
def test_driver_wavefront_matches_jax_driver(monkeypatch, rows):
    ja, jm, js, jc, ta, tm, ts, tc = _driver_pair(monkeypatch,
                                                  rows_per_pass=rows)
    want, jstats = jax_driver(ja, jm, js.camera, jc)
    got, stats = render_driver(ta, tm, ts.camera, tc)
    assert stats.backend == jstats.backend == "wavefront"
    assert stats.segments == jstats.segments == 2
    pixel_rule(got, want)


def test_driver_wavefront_checkpoint_resume(monkeypatch, tmp_path):
    _, _, _, _, ta, tm, ts, tc = _driver_pair(monkeypatch, rows_per_pass=4)

    def run(**kw):
        return render_driver(ta, tm, ts.camera, tc, checkpoint_every=1, **kw)

    full, _ = run(checkpoint_path=str(tmp_path / "full.npz"))
    ck = str(tmp_path / "ck.npz")
    monkeypatch.setenv("PT_FAULT_INJECT", "2")
    monkeypatch.setenv("PT_FAULT_COUNT", "9")
    with pytest.raises(DeviceFailure):
        run(checkpoint_path=ck)
    with np.load(ck) as z:
        assert int(z["chunks_done"]) == 2
        assert '"layout": "linear"' in str(z["meta"])
        assert '"backend": "wavefront"' in str(z["meta"])
    monkeypatch.delenv("PT_FAULT_INJECT")
    img, _ = run(checkpoint_path=ck, resume=True)
    assert np.array_equal(img, full)
    # a megakernel render does not resume a wavefront checkpoint
    with pytest.raises(ValueError, match="backend"):
        render_driver(ta, tm, ts.camera, tc.replace(backend="pallas"),
                      checkpoint_path=ck, checkpoint_every=1, resume=True)


def test_driver_backend_choice():
    _, _, _, _, ta, tm, ts, tc = pair("reference", width=8, height=6)
    from pathtracer_tpu_torch.driver import use_megakernel

    assert use_megakernel(tm, tc)
    assert not use_megakernel(tm, tc.replace(backend="wavefront"))
    assert not use_megakernel(tm, tc.replace(dtype="float64"))
    assert not use_megakernel(tm, tc.replace(debug_ray=3))
    assert use_megakernel(tm, tc.replace(backend="pallas", debug_ray=3))


def test_render_key_is_explicit():
    # the same key renders the same image; another key another one
    _, _, _, _, ta, tm, ts, tc = pair("reference", width=8, height=6,
                                      samples=2)
    a = integrator.render(ta, tm, ts.camera, tc, key=threefry.prng_key(1))
    b = integrator.render(ta, tm, ts.camera, tc, key=threefry.prng_key(1))
    c = integrator.render(ta, tm, ts.camera, tc, key=threefry.prng_key(2))
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def measure():
    """Print the measured differences the rules above were set from: for
    each comparison, the worst pixel's channel difference, the pixels
    above 1e-5 and 1e-3, and the largest channel-mean difference.
    From the repository root: `JAX_PLATFORMS=cpu PYTHONPATH=. python
    tests/test_torch_wavefront_render.py`."""
    def show(tag, got, want):
        d = pixel_diff(got, want)
        mean = np.abs(got.mean((0, 1)) - want.mean((0, 1))).max()
        print(f"{tag}: worst {d.max():.3g}, above 1e-5 {(d > 1e-5).sum()}, "
              f"above 1e-3 {(d > 1e-3).sum()} of {d.size} "
              f"({(d <= 1e-3).mean():.4f} within), means {mean:.3g}")

    for name, cfg in sorted(GOLDEN_CFG.items()):
        with np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) as z:
            show(f"golden {name}", port_render(name, **cfg), z["img"])
    for name, nee, spp in [("reference", True, 8), ("teapot", True, 4),
                           ("cubemap", False, 4)]:
        ja, jm, js, jc, ta, tm, ts, tc = pair(
            name, width=32, height=24, samples=spp, samples_per_pass=4,
            seed=7, nee=nee)
        show(f"JAX wavefront {name} nee={nee}",
             integrator.render(ta, tm, ts.camera, tc),
             jax_render(ja, jm, js.camera, jc))
    for name, nee in [("reference", True), ("teapot", True),
                      ("textures", False)]:
        _, _, _, _, ta, tm, ts, tc = pair(name, width=32, height=24,
                                          samples=4, samples_per_pass=4,
                                          seed=5, nee=nee)
        route = integrator.intersect_route(
            ta, tm, tc, fn=mk.intersect_batch_reference)
        show(f"K5 route {name} (ties: its test counts them)",
             integrator.render(ta, tm, ts.camera, tc, route=route),
             integrator.render(ta, tm, ts.camera, tc))
    ja, jm, js, jc, ta, tm, ts, tc = pair(
        "reference", width=24, height=10, samples=4, samples_per_pass=2,
        seed=9, rows_per_pass=4)
    show("row blocks", integrator.render(ta, tm, ts.camera, tc),
         jax_render(ja, jm, js.camera, jc))
    os.environ["PT_SEG_SPP"] = "4"
    for rows in (0, 4):
        ja, jm, js, jc, ta, tm, ts, tc = pair(
            "reference", width=24, height=10, samples=8, samples_per_pass=2,
            seed=3, backend="wavefront", rows_per_pass=rows)
        show(f"driver rows_per_pass={rows}",
             render_driver(ta, tm, ts.camera, tc)[0],
             jax_driver(ja, jm, js.camera, jc)[0])


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    measure()
