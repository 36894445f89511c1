"""Benchmark of the PyTorch + CUDA port: `python -m pathtracer_tpu_torch.bench`.

The record of the repository's bench.py, measured the same way on the
port, without JAX: the `reference` Cornell scene (scenes/reference.go:12)
at 1280x960, camera samples traced per second (Msamples/s), steady state
(the kernel build and first launch excluded), against the reference's
best published time, an RTX 2080 at 45.43 s for 1280x960 x 2048 spp
(BASELINE.md) => 55.4 Msamples/s.

Environment (as bench.py): BENCH_BACKEND (`pallas`: the megakernel, the
default; `wavefront`: the wavefront integrator, whose f32 nearest hits
take the intersect kernel; `diff`: fwd+bwd through the differentiable
megakernel), BENCH_SPP (default 128 on the megakernel, 32 otherwise),
BENCH_WIDTH, BENCH_HEIGHT, BENCH_SCENE, BENCH_EXTRA ("1": every extra
record, "0": none, or a comma-separated list of their keys) and
BENCH_DIFF_BACKEND (`wavefront` forces the wavefront autograd path, which
bench.py's bench_diff_wavefront measures and which is also the path of
every scene the megakernel steps do not train, such as the normal-mapped
`textures`: its fwd_bwd record).
It runs on the CUDA card, or on the CPU (the kernels' plain versions)
only when BENCH_DEVICE=cpu.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"extra"}. "extra" holds bench.py's keys (fwd_<scene>, fwd_bwd_<scene>,
full_render_1280x960x2048) and the port's own, prefixed `torch_`. A
record that fails says so ({"error": ...}); if the headline fails, the
line carries "error" and the exit code is 1.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .config import RenderConfig
from .render import integrator, threefry
from .render import megakernel as mk
from .scenes import get_scene

BASELINE_MSPS = 1280 * 960 * 2048 / 45.43 / 1e6  # 55.39 Msamples/s
# per-scene reference baselines (BASELINE.md): best published wall times
# at 1280x960 x 2048 spp on the RTX 2080
SCENE_BASELINES = {
    "reference": BASELINE_MSPS,
    "teapot": 1280 * 960 * 2048 / (29 * 60 + 20) / 1e6,   # 29m20s -> 1.43
    "gopher": 1280 * 960 * 2048 / (47 * 60) / 1e6,        # 47m    -> 0.89
}
# the repository ships no .obj files: teapot and gopher render procedural
# stand-in meshes, so their ratios are not like for like
STAND_INS = ("teapot", "gopher")
# bench.py's extra records: (scene, kind, spp); fwd_bwd_textures takes the
# wavefront autograd path (its normal maps)
EXTRAS = (("teapot", "fwd", 8), ("gopher", "fwd", 8),
          ("textures", "fwd", 32), ("textures-file", "fwd", 32),
          ("cubemap", "fwd", 8), ("envmap-file", "fwd", 32),
          ("reference", "fwd_bwd", 32), ("textures-train", "fwd_bwd", 32),
          ("textures", "fwd_bwd", 32))
K5_RAYS_SPP = 8   # the intersect kernel's batch: W x H x 8 camera rays


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev: torch.device) -> float:
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    return time.perf_counter() - t0


def _kernel_seconds(fn, dev: torch.device, reps: int) -> float:
    """Seconds a call of `fn` takes on the device, after a warm-up call:
    `reps` calls back to back between two CUDA events, divided (as
    chip_smoke.py's cuda_ms), so no host launch or synchronize latency is
    counted; on the CPU by the host clock."""
    fn()
    _sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 1e3 / reps


def bench_megakernel(cfg, sc, arrays, meta, spp, dev):
    """bench.py's bench_pallas: one megakernel launch of `spp` samples on
    the driver's tile and layout for the scene; the best of 3 timed
    launches after a warm-up. Returns (samples, seconds)."""
    W, H = cfg.width, cfg.height
    launch = mk.image_launch(arrays, meta, sc.camera, spp, dev)

    def run(seed):
        mk.trace_tiles((seed, 0), *launch.tables, meta=meta, cfg=cfg,
                       spp=spp, total_samples=cfg.samples, **launch.kwargs)

    _timed(lambda: run(0), dev)
    best = min(_timed(lambda i=i: run(i + 1), dev) for i in range(3))
    return W * H * spp, best


def bench_wavefront(cfg, sc, arrays, meta, spp, dev):
    """bench.py's bench_wavefront: the wavefront integrator's passes of
    cfg.samples_per_pass samples over the whole image (the intersect
    kernel's tables built once), `spp` samples a run; the median of 3
    timed runs after a warm-up. Returns (samples, seconds)."""
    W, H = cfg.width, cfg.height
    spp_chunk = min(cfg.samples_per_pass, spp)
    cfg = cfg.replace(samples_per_pass=spp_chunk)
    n_chunks = max(1, spp // spp_chunk)
    px, py = integrator.pixel_grid(W, 0, H, dev)
    cam = sc.camera.pack(torch.float32, dev)
    route = integrator.intersect_route(arrays, meta, cfg)

    def run(seed):
        integrator.render_chunks(arrays, meta, cfg, cam, px, py, 0,
                                 n_chunks, threefry.prng_key(seed), route)

    _timed(lambda: run(0), dev)
    times = [_timed(lambda i=i: run(i + 1), dev) for i in range(3)]
    return W * H * n_chunks * spp_chunk, statistics.median(times)


def _staged_textures(meta) -> bool:
    """bench.py's staged_ok: the scene trains texels through the texel
    mode of the gradient kernel."""
    return (bool(meta.textured_types) and mk.staged_lanes(meta) > 0
            and not meta.has_normal_maps)


def _step_rate(step, params, target, dev, n=3):
    """bench.py:160-173: one warm-up step, then n steps with new seeds,
    the loss read once at the end. Returns seconds for the n steps."""
    *params, loss = step(*params, (1, 0), target)
    float(loss)
    t0 = time.perf_counter()
    for i in range(n):
        *params, loss = step(*params, (i + 2, 0), target)
    float(loss)
    _sync(dev)
    return time.perf_counter() - t0


def bench_diff_wavefront(cfg, sc, arrays, meta, spp, dev):
    """bench.py's bench_diff_wavefront: max(1, spp // 8) SGD steps
    (diff.train_step) of 1 spp over the whole W x H image, every
    SceneParams field trainable, a zero target and one key, after a
    warm-up step; the intersect kernel's tables built once. Returns
    (samples, seconds)."""
    from .diff import extract_params, train_step
    from .render.vec3 import Vec3

    W, H = cfg.width, cfg.height
    cam = sc.camera.pack(torch.float32, dev)
    px, py = integrator.pixel_grid(W, 0, H, dev)
    params = extract_params(arrays)
    target = Vec3.zeros((px.shape[0],), torch.float32, dev)
    key = threefry.prng_key(0)
    route = integrator.intersect_route(arrays, meta,
                                       cfg.replace(early_exit=False))
    n = max(1, spp // 8)

    def step(p):
        return train_step(p, arrays, meta, cfg, cam, px, py, key, 1,
                          target, route=route)[0]

    p2 = step(params)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        p2 = step(p2)
    _sync(dev)
    return W * H * n, time.perf_counter() - t0


def bench_diff(cfg, sc, arrays, meta, spp, dev, tri=False):
    """bench.py's bench_diff: on the differentiable megakernel, 3 SGD steps
    of min(spp, 32) samples (object colors, or texels on scenes with
    staged textures; per-triangle colors with `tri`) after a warm-up;
    where bench.py takes its wavefront autograd (BENCH_DIFF_BACKEND=
    wavefront, or a scene the megakernel steps do not train),
    bench_diff_wavefront. Returns (samples, seconds)."""
    from .diff import (make_megakernel_step, make_megakernel_step_tex,
                       make_megakernel_step_tri)
    from .scene.pack import texel_params

    tex = _staged_textures(meta)
    untextured = not meta.textured_types and not meta.has_normal_maps
    if (os.environ.get("BENCH_DIFF_BACKEND", "auto") == "wavefront"
            or not mk.supports_scene(meta) or not (untextured or tex)):
        return bench_diff_wavefront(cfg, sc, arrays, meta, spp, dev)
    W, H = cfg.width, cfg.height
    step_spp = max(1, min(spp, 32))
    if tri:
        step, target_of = make_megakernel_step_tri(
            arrays, meta, cfg, sc.camera, n_passes=1, spp=step_spp)
        params = (arrays.color, arrays.emission, arrays.tri_color)
    elif tex:
        step, target_of = make_megakernel_step_tex(
            arrays, meta, cfg, sc.camera, spp=step_spp)
        params = (arrays.color, arrays.emission, texel_params(arrays))
    else:
        step, target_of = make_megakernel_step(
            arrays, meta, cfg, sc.camera, spp=step_spp)
        params = (arrays.color, arrays.emission)
    target = target_of(np.zeros((H, W, 3), np.float32))
    n = 3
    return W * H * step_spp * n, _step_rate(step, params, target, dev, n)


def bench_k5(width, height, scene, dev):
    """The intersect kernel (megakernel.intersect_batch) on the wavefront's
    primary rays of `scene`, W x H x 8 a batch (9,830,400 at 1280x960),
    its tables built once: 10 launches back to back after a warm-up,
    timed by CUDA events (_kernel_seconds), as chip_smoke.py's phase 9
    times it. Returns Grays/s."""
    cfg = RenderConfig(width=width, height=height, samples=K5_RAYS_SPP)
    sc = get_scene(scene, cfg)
    arrays, meta = sc.pack(device=dev)
    tables = mk.intersect_tables(arrays, meta, dev)
    px, py = integrator.pixel_grid(width, 0, height, dev)
    n = px.shape[0] * K5_RAYS_SPP
    key = threefry.prng_key(0)
    jx, jy = threefry.uniform(key, (2, n), dev)
    o, d = integrator.rays_for_pixels(
        sc.camera.pack(torch.float32, dev),
        torch.repeat_interleave(px, K5_RAYS_SPP),
        torch.repeat_interleave(py, K5_RAYS_SPP), jx, jy,
        torch.arange(K5_RAYS_SPP, dtype=torch.int32,
                     device=dev).repeat(px.shape[0]), K5_RAYS_SPP)
    o, d = tuple(o), tuple(d)

    def run():
        mk.intersect_batch(arrays, meta, cfg, o, d, tables=tables)

    return n / _kernel_seconds(run, dev, 10) / 1e9


def _rate_record(scene, fn, spp, width, height, dev, **cfg_kw):
    """One extra record: {"Msamples_per_sec", and vs_baseline for the
    forward of a baseline scene} or {"error": ...}."""
    try:
        cfg = RenderConfig(width=width, height=height, samples=2048,
                           samples_per_pass=8, **cfg_kw)
        sc = get_scene(scene, cfg)
        arrays, meta = sc.pack(device=dev)
        res = fn(cfg, sc, arrays, meta, spp, dev)
        msps = res[0] / res[1] / 1e6
        rec = {"Msamples_per_sec": msps}
        if scene in SCENE_BASELINES and fn is bench_megakernel:
            rec["vs_baseline"] = round(msps / SCENE_BASELINES[scene], 4)
            if scene in STAND_INS:
                rec["stand_in"] = True
        return rec
    except Exception as e:  # noqa: BLE001 - record the miss, move on
        return {"error": f"{type(e).__name__}: {e}"[:200]}


def _wanted(key: str) -> bool:
    sel = os.environ.get("BENCH_EXTRA", "1")
    if sel in ("1", "0"):
        return sel == "1"
    return key in {k.strip() for k in sel.split(",")}


def _extra_records(width, height, dev) -> dict:
    """bench.py's extra records and the port's own (torch_*), each
    fault-isolated."""
    out = {}
    for scene, kind, spp in EXTRAS:
        key = f"{kind}_{scene}"
        if _wanted(key):
            fn = bench_diff if kind == "fwd_bwd" else bench_megakernel
            out[key] = _rate_record(scene, fn, spp, width, height, dev)
    for scene in ("reference", "teapot"):
        key = f"torch_fwd_{scene}_nee"
        if _wanted(key):
            out[key] = _rate_record(scene, bench_megakernel, 8, width,
                                    height, dev, nee=True)
    if _wanted("torch_fwd_bwd_teapot_tri"):
        out["torch_fwd_bwd_teapot_tri"] = _rate_record(
            "teapot", lambda *a: bench_diff(*a, tri=True), 8, width, height,
            dev)
    if _wanted("torch_k5_Grays_per_sec"):
        rec = {}
        for scene in ("reference", "teapot"):
            try:
                rec[scene] = round(bench_k5(width, height, scene, dev), 4)
            except Exception as e:  # noqa: BLE001 - record the miss
                rec[scene] = {"error": f"{type(e).__name__}: {e}"[:200]}
        out["torch_k5_Grays_per_sec"] = rec
    return out


def _full_render_record(width, height, dev) -> dict:
    """bench.py's full_render_1280x960x2048: the whole `reference` render
    at width x height x 2048 spp through driver.render_driver, scene
    build, segments and the host copy included (what the reference's
    45.43 s is). The first (cold) run, then the median and spread of 3
    warm runs; nothing is retried."""
    from .driver import render_driver

    def one():
        t0 = time.perf_counter()
        cfg = RenderConfig(width=width, height=height, samples=2048,
                           samples_per_pass=8)
        sc = get_scene("reference", cfg)
        arrays, meta = sc.pack(device=dev)
        img, stats = render_driver(arrays, meta, sc.camera, cfg)
        wall = time.perf_counter() - t0
        if not (np.isfinite(img).all() and float(img.mean()) > 0.0):
            raise ValueError("the render is not a finite, lit image")
        return wall, stats

    key = "full_render_1280x960x2048"
    try:
        cold, _ = one()
        warm = [one() for _ in range(3)]
        walls = [w for w, _ in warm]
        med = statistics.median(walls)
        stats = sorted(warm, key=lambda r: r[0])[1][1]
        total = width * height * 2048
        return {key: {
            "wall_s": round(med, 4),
            "wall_s_first_run": round(cold, 4),
            "wall_s_warm_runs": [round(w, 4) for w in walls],
            "wall_s_spread": round(max(walls) - min(walls), 4),
            "Msamples_per_sec_e2e": round(total / med / 1e6, 1),
            "vs_baseline_wall": round(45.43 / med, 2),
            "device_Msamples_per_sec": round(stats.msamples_per_sec, 1),
        }}
    except Exception as e:  # noqa: BLE001 - never sink the headline
        return {key: {"error": f"{type(e).__name__}: {e}"[:200]}}


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or the
    device's name where nvidia-smi cannot say."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, check=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


def main() -> int:
    width = int(os.environ.get("BENCH_WIDTH", "1280"))
    height = int(os.environ.get("BENCH_HEIGHT", "960"))
    backend = os.environ.get("BENCH_BACKEND", "pallas")
    spp = int(os.environ.get("BENCH_SPP", "128" if backend == "pallas"
                             else "32"))
    scene = os.environ.get("BENCH_SCENE", "reference")
    tag = "_fwd_bwd" if backend == "diff" else ""
    metric = f"{scene}{tag}_{width}x{height}_Msamples_per_sec"
    rec = {"metric": metric, "value": None, "unit": "Msamples/s",
           "vs_baseline": None}
    try:
        fn = {"pallas": bench_megakernel, "wavefront": bench_wavefront,
              "diff": bench_diff}[backend]
        if os.environ.get("BENCH_DEVICE") == "cpu":
            dev = torch.device("cpu")
        elif torch.cuda.is_available():
            dev = torch.device("cuda:0")
        else:
            raise RuntimeError("no CUDA device (BENCH_DEVICE=cpu runs the "
                               "plain versions on the CPU)")
        rec["torch_device"] = card_name(dev)
        cfg = RenderConfig(width=width, height=height, samples=2048,
                           samples_per_pass=8)
        sc = get_scene(scene, cfg)
        arrays, meta = sc.pack(device=dev)
        res = fn(cfg, sc, arrays, meta, spp, dev)
    except Exception as e:  # noqa: BLE001 - still print a parseable line
        rec["error"] = f"{type(e).__name__}: {e}"[:200]
        print(json.dumps(rec))
        return 1
    msps = res[0] / res[1] / 1e6
    rec["value"] = msps
    rec["vs_baseline"] = round(
        msps / SCENE_BASELINES.get(scene, BASELINE_MSPS), 4)
    if scene in STAND_INS:
        rec["stand_in"] = True
    extra = _extra_records(width, height, dev)
    if (scene == "reference" and backend == "pallas"
            and _wanted("full_render_1280x960x2048")):
        extra.update(_full_render_record(width, height, dev))
    if extra:
        rec["extra"] = extra
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
