"""The program's spans (pathtracer_tpu_torch/spans.py) and the pack's
seconds by part (scene.pack.pack_scene.seconds), on the CPU.

- A profiled render through driver.render_driver holds "pt.layout",
  "pt.fetch" and "pt.untile" once a frame, "pt.segment", "pt.stack" (in
  its segment) and "pt.accumulate" once a segment; the CLI's --profile
  trace (profile_dir) covers the frame from its layout to its untile.
- A profiled AD step (diff.loss_and_grads) holds "pt.ad.forward",
  "pt.ad.backward", one "pt.bounce" a bounce with its three parts, and the
  "pt.rng" draws; with the memory free patched to 0 on a textured scene
  the backward holds the recomputed bounces' spans, max_bounces less the
  plain ones.
- The gradient megakernel's Functions hold "pt.grad.forward" and
  "pt.grad.backward" once a call.
- With no profiler running no record_function is entered.
- pack_scene.seconds has every part after a pack.

No JAX."""
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_scenes import free_bytes, free_for
from pathtracer_tpu_torch import spans
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.diff import extract_params, loss_and_grads
from pathtracer_tpu_torch.diff.grad import (make_megakernel_step,
                                            make_megakernel_step_tri)
from pathtracer_tpu_torch.driver import render_driver
from pathtracer_tpu_torch.render import integrator, threefry
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.render.vec3 import Vec3
from pathtracer_tpu_torch.scene.pack import pack_scene
from pathtracer_tpu_torch.scenes import get_scene

CPU = torch.device("cpu")
W, H = 8, 6
PARTS = ("bvh", "octant", "textures", "tables", "device")
GROUPS = ("pt.bounce.intersect", "pt.bounce.attrs", "pt.bounce.shade")


def _scene(name, **kw):
    cfg = RenderConfig(width=W, height=H, **kw)
    sc = get_scene(name, cfg)
    scn, meta = sc.pack(device=CPU)
    return sc, scn, meta, cfg


def _profiled(fn):
    """(fn's result, [(name, start, end)] of the "pt." spans that ran in
    it, in start order; times in microseconds)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sorted(((e.name, e.time_range.start, e.time_range.end)
                        for e in prof.events() if e.name.startswith("pt.")),
                       key=lambda s: s[1])


def _count(got, name, within=None):
    """The spans `name` of `got`, those starting inside the span `within`
    (a (name, start, end)) where given."""
    return sum(1 for n, a, b in got if n == name and (
        within is None or within[1] <= a < within[2]))


def _one(got, name):
    found = [s for s in got if s[0] == name]
    assert len(found) == 1, (name, found)
    return found[0]


@pytest.mark.parametrize("name,samples,seg_spp", [("reference", 4, 2),
                                                  ("teapot", 4, 2)])
def test_render_driver_frame_parts(monkeypatch, name, samples, seg_spp):
    monkeypatch.setenv("PT_SEG_SPP", str(seg_spp))
    sc, scn, meta, cfg = _scene(name, samples=samples, samples_per_pass=2)
    (img, stats), got = _profiled(
        lambda: render_driver(scn, meta, sc.camera, cfg))
    n = samples // seg_spp
    assert stats.segments == n
    for part in ("pt.layout", "pt.fetch", "pt.untile"):
        assert _count(got, part) == 1, part
    for part in ("pt.segment", "pt.stack", "pt.accumulate"):
        assert _count(got, part) == n, part
    # the stack of a segment's sums inside its segment; no event to wait
    # on off the card
    for seg in [s for s in got if s[0] == "pt.segment"]:
        assert _count(got, "pt.stack", within=seg) == 1
    assert _count(got, "pt.wait") == 0
    layout, untile = _one(got, "pt.layout"), _one(got, "pt.untile")
    assert layout[2] <= min(s[1] for s in got if s[0] == "pt.segment")
    assert untile[1] >= _one(got, "pt.fetch")[2]
    assert img.shape == (H, W, 3)


def test_profile_dir_covers_the_frame(monkeypatch, tmp_path):
    monkeypatch.setenv("PT_SEG_SPP", "2")
    sc, scn, meta, cfg = _scene("reference", samples=4, samples_per_pass=2)
    render_driver(scn, meta, sc.camera, cfg, profile_dir=str(tmp_path))
    ev = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in ev if e.get("cat") == "user_annotation"]
    assert names.count("pt.layout") == 1 and names.count("pt.untile") == 1
    assert names.count("pt.segment") == 2 and names.count("pt.fetch") == 1


def _loss_and_grads(name, samples=1, route="walk"):
    sc, scn, meta, cfg = _scene(name, samples=samples,
                                samples_per_pass=samples)
    cam = sc.camera.pack(torch.float32, CPU)
    px, py = integrator.pixel_grid(W, 0, H, CPU)
    r = (integrator.intersect_route(scn, meta, cfg,
                                    fn=mk.intersect_batch_reference)
         if route == "kernel" else None)
    target = Vec3.zeros((px.shape[0],), torch.float32, CPU)
    return cfg, lambda: loss_and_grads(
        extract_params(scn), scn, meta, cfg, cam, px, py,
        threefry.prng_key(5), samples, target, route=r)


@pytest.mark.parametrize("route", ["walk", "kernel"])
def test_ad_step_spans(route):
    cfg, step = _loss_and_grads("reference", route=route)
    _, got = _profiled(step)
    fwd, bwd = _one(got, "pt.ad.forward"), _one(got, "pt.ad.backward")
    assert fwd[2] <= bwd[1]
    n = cfg.max_bounces
    assert _count(got, "pt.bounce", within=fwd) == n
    for part in GROUPS:
        assert _count(got, part, within=fwd) == n, part
    # nothing recomputed where the batch fits
    assert _count(got, "pt.bounce", within=bwd) == 0
    # the draws: the camera's jitter and the bounces' key (render_pass),
    # each bounce's key and its uniforms, under the shading
    assert _count(got, "pt.rng", within=fwd) == 3 + 2 * n
    for b in [s for s in got if s[0] == "pt.bounce.shade"]:
        assert _count(got, "pt.rng", within=b) == 1


@pytest.mark.parametrize("plain", [0, 4])
def test_recomputed_bounces_enter_their_spans_in_the_backward(plain):
    cfg, step = _loss_and_grads("textures", samples=2, route="kernel")
    room = 0 if plain == 0 else free_for(plain, W * H * 2)
    with free_bytes(room):
        _, got = _profiled(step)
    n = cfg.max_bounces
    fwd, bwd = _one(got, "pt.ad.forward"), _one(got, "pt.ad.backward")
    assert _count(got, "pt.bounce", within=fwd) == n
    assert _count(got, "pt.bounce", within=bwd) == n - plain
    for part in GROUPS:
        assert _count(got, part, within=bwd) == n - plain, part


@pytest.mark.parametrize("name", ["reference", "teapot"])
def test_grad_megakernel_spans(name):
    sc, scn, meta, cfg = _scene(name, samples=1, samples_per_pass=1)
    tile, seed = (8, 128), (7, 0)
    if name == "teapot":
        step, target_of = make_megakernel_step_tri(
            scn, meta, cfg, sc.camera, n_passes=1, tile=tile, spp=1)
        args = (scn.color, scn.emission, scn.tri_color, seed)
    else:
        step, target_of = make_megakernel_step(scn, meta, cfg, sc.camera,
                                               spp=1, tile=tile)
        args = (scn.color, scn.emission, seed)
    target = target_of(torch.zeros((H, W, 3)).numpy())
    _, got = _profiled(lambda: step(*args, target))
    fwd, bwd = _one(got, "pt.grad.forward"), _one(got, "pt.grad.backward")
    assert fwd[2] <= bwd[1]


def test_no_record_function_without_a_profiler(monkeypatch):
    """Off the profiler a span is a flag check: record_function is never
    entered (and is, under one)."""
    entered = []
    real = torch.profiler.record_function

    def counted(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setenv("PT_SEG_SPP", "2")
    sc, scn, meta, cfg = _scene("reference", samples=4, samples_per_pass=2)
    _, step = _loss_and_grads("reference")

    def work():
        render_driver(scn, meta, sc.camera, cfg)
        step()
    work()
    assert entered == []
    assert spans.span("pt.x") is spans.span("pt.y")
    _profiled(work)
    assert {"pt.layout", "pt.ad.forward", "pt.bounce", "pt.rng"} <= set(
        entered)


@pytest.mark.parametrize("name,octant,textures", [
    ("teapot", True, False), ("reference", False, False),
    ("textures", False, True)])
def test_pack_seconds_by_part(name, octant, textures):
    cfg = RenderConfig(width=W, height=H, samples=1)
    sc = get_scene(name, cfg)
    t = time.perf_counter()
    sc.pack(device=CPU)
    wall = time.perf_counter() - t
    secs = pack_scene.seconds
    assert set(secs) == set(PARTS)
    assert all(v >= 0.0 for v in secs.values())
    assert sum(secs.values()) <= wall
    assert (secs["octant"] > 0.0) == octant
    assert secs["bvh"] > 0.0 and secs["device"] > 0.0
    if textures:
        assert secs["textures"] > 0.0
