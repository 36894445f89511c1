#!/usr/bin/env python3
"""Timing probe of the CUDA megakernel of pathtracer_tpu_torch on one card.

Run from the root of the checkout on a machine with a CUDA card:

    python3 tools/cuda_megakernel_probe.py

It imports no jax. It prints, one result a line:

1. the card's name, power limit, SM clock and temperature (nvidia-smi);
2. an A/B of the shipped build (-fmad=false) against -fmad=true: the
   kernel on `reference` at 1280x960x8 spp, 20 launches a timing by CUDA events, in the
   order default, fmad, fmad, default, three times over; then each
   build's agreement with the plain PyTorch version on the same inputs;
3. one 128-spp launch (the driver's segment), timed three times;
4. three driver runs at 1280x960x2048 spp (wall, Msamples/s);
5. one more driver run under torch.profiler: device time by kernel, the
   kernel's share of it, and the device's idle share inside the segment
   loop and against the driver wall, all read from the device timeline of
   that one trace.

Steps 4 and 5 run for `reference` and then for `teapot` (the 1472-triangle
stand-in; 256 segments of 8 spp, the mesh instantiation of the kernel).

With `--train` it runs only this: three training steps under
torch.profiler after one warm-up step, `make_megakernel_step` on
`reference` (32 spp a step) and `make_megakernel_step_tri` on `teapot` (8
spp a step) at 1280x960, with bench.py's zero target: device time by
kernel, the forward and gradient kernels' shares of it, and the device's
idle share of the steps' wall.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from pathtracer_tpu_torch.config import RenderConfig  # noqa: E402
from pathtracer_tpu_torch.diff import (make_megakernel_step,  # noqa: E402
                                       make_megakernel_step_tri)
from pathtracer_tpu_torch.driver import render_driver  # noqa: E402
from pathtracer_tpu_torch.render import _build  # noqa: E402
from pathtracer_tpu_torch.render import megakernel as mk  # noqa: E402
from pathtracer_tpu_torch.scenes import get_scene  # noqa: E402

W, H, TILE = 1280, 960, (64, 256)
DEFAULT = _build.NVCC_FLAGS
FMAD = tuple("-fmad=true" if f == "-fmad=false" else f for f in DEFAULT)


def inputs(spp, dev):
    cfg = RenderConfig(width=W, height=H, samples=spp, samples_per_pass=spp)
    sc = get_scene("reference", cfg)
    arrays, meta = sc.pack(device=dev)
    xs, ys, _ = mk.tile_pixel_layout(W, H, *TILE, order="linear")
    tabs = [torch.from_numpy(t).to(dev) for t in (
        mk.build_camera_vec(sc.camera), mk.build_scene_table(arrays, meta),
        *mk.build_mesh_tables(arrays, meta), xs, ys)]
    return tabs, dict(meta=meta, cfg=cfg, spp=spp, total_samples=spp,
                      tile=TILE)


def run(flags, tabs, kw):
    _build.NVCC_FLAGS = flags
    try:
        return mk.trace_tiles((1, 0), *tabs, **kw)
    finally:
        _build.NVCC_FLAGS = DEFAULT


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def union_us(spans):
    """Total length of the union of (start, end) spans."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def device_timeline(prof):
    """(kernel, memcpy and memset events) of a profile, from its chrome
    trace: a list of (name, start_us, end_us)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset")]


def main():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print("card:", smi, "| torch", torch.__version__, "cuda",
          torch.version.cuda, flush=True)
    dev = torch.device("cuda:0")
    if "--train" in sys.argv[1:]:
        for scene in ("reference", "teapot"):
            train_trace(scene, dev)
        return 0

    # ---- 2: -fmad A/B at 8 spp -----------------------------------------
    tabs, kw = inputs(8, dev)
    for flags in (DEFAULT, FMAD):
        run(flags, tabs, kw)                  # builds and loads each
    times = {"default": [], "fmad": []}
    for _ in range(3):
        for name, flags in (("default", DEFAULT), ("fmad", FMAD),
                            ("fmad", FMAD), ("default", DEFAULT)):
            times[name].append(cuda_ms(lambda: run(flags, tabs, kw), 20))
    for name, ts in times.items():
        print(f"8 spp {name}: ms {ts} median {np.median(ts):.4f} spread "
              f"{(max(ts) - min(ts)) / np.median(ts):.4f}", flush=True)
    plain = torch.stack(mk.trace_tiles_reference((1, 0), *tabs, **kw))
    plain = plain.cpu().numpy()
    for name, flags in (("default", DEFAULT), ("fmad", FMAD)):
        k = torch.stack(run(flags, tabs, kw)).cpu().numpy()
        print(f"8 spp {name} vs plain: bit-equal {(k == plain).mean():.6f}"
              f" within atol=1e-4 rtol=1e-3 "
              f"{np.isclose(k, plain, atol=1e-4, rtol=1e-3).mean():.7f}"
              f" max abs err {np.abs(k - plain).max():.4g}", flush=True)

    # ---- 3: one 128-spp launch -----------------------------------------
    tabs, kw = inputs(128, dev)
    t128 = [cuda_ms(lambda: run(DEFAULT, tabs, kw), 3) for _ in range(3)]
    print("128 spp launch ms", t128, "= per 8 spp",
          [t / 16 for t in t128], flush=True)

    # ---- 4 and 5: driver runs, one traced, for each scene ---------------
    for scene in ("reference", "teapot"):
        if driver_runs(scene, dev):
            return 0
    return 0


def driver_runs(scene, dev):
    """Three driver runs of `scene` at W x H x 2048 spp and one more under
    torch.profiler. Returns True when the trace shows no device events."""
    cfg = RenderConfig(width=W, height=H, samples=2048)
    sc = get_scene(scene, cfg)
    arrays, meta = sc.pack(device=dev)
    for i in range(3):
        _, st = render_driver(arrays, meta, sc.camera, cfg)
        print(f"{scene} driver run {i}: wall {st.wall_s:.4f} s "
              f"{st.msamples_per_sec:.1f} Msamples/s, {st.segments} "
              f"segments", flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, st = render_driver(arrays, meta, sc.camera, cfg)
        host = time.perf_counter() - t0
    events = device_timeline(prof)
    if not events:
        print("traced run: no device events in the trace; idle share not "
              "measured", flush=True)
        return True
    by_name = {}
    for name, s, e in events:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (e - s)
    k1 = [(s, e) for name, s, e in events if "megakernel" in name]
    lo = min(s for s, _ in k1)
    hi = max(e for _, s, e in events)
    inside = [(max(s, lo), min(e, hi)) for _, s, e in events if e > lo]
    busy = union_us(inside)
    print(f"{scene} traced run: host wall of render_driver {host:.4f} s, "
          f"driver wall {st.wall_s:.4f} s", flush=True)
    print(f"{scene} traced run: device us by kernel", json.dumps(by_name),
          flush=True)
    print(f"{scene} traced run: {len(k1)} megakernel launches, "
          f"{sum(e - s for s, e in k1) / 1e3:.3f} ms, "
          f"{sum(e - s for s, e in k1) / sum(by_name.values()):.4f} of "
          f"device time", flush=True)
    print(f"{scene} traced run: segment loop on the device (first "
          f"megakernel start to last device op end) {(hi - lo) / 1e3:.3f} "
          f"ms, busy {busy / 1e3:.3f} ms, idle share "
          f"{1.0 - busy / (hi - lo):.4f}; against the driver wall "
          f"{1.0 - busy / 1e6 / st.wall_s:.4f}", flush=True)
    return False


def train_trace(scene, dev):
    """Three training steps of `scene` at W x H under torch.profiler, after
    one warm-up step: device time by kernel, the forward (kGrad = false)
    and gradient (kGrad = true) kernels' time, and the device's idle share
    of the steps' wall."""
    tri = scene == "teapot"
    spp = 8 if tri else 32
    cfg = RenderConfig(width=W, height=H, samples=spp, samples_per_pass=spp)
    sc = get_scene(scene, cfg)
    arrays, meta = sc.pack(device=dev)
    if tri:
        step, target_of = make_megakernel_step_tri(
            arrays, meta, cfg, sc.camera, n_passes=1, spp=spp)
        params = (arrays.color, arrays.emission, arrays.tri_color)
    else:
        step, target_of = make_megakernel_step(arrays, meta, cfg,
                                               sc.camera, spp=spp)
        params = (arrays.color, arrays.emission)
    target = target_of(np.zeros((H, W, 3), np.float32))
    *params, loss = step(*params, (1, 0), target)
    float(loss)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3):
            *params, loss = step(*params, (i + 2, 0), target)
        float(loss)
        wall = time.perf_counter() - t0
    events = device_timeline(prof)
    if not events:
        print(f"{scene} training trace: no device events", flush=True)
        return
    by_name, kern = {}, {"forward": 0.0, "gradient": 0.0}
    for name, s, e in events:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (e - s)
        m = re.search(r"megakernel<\w+, (\w+)>", name)
        if m:
            kern["gradient" if m.group(1) == "true" else "forward"] += e - s
    total = sum(by_name.values())
    busy = union_us([(s, e) for _, s, e in events])
    print(f"{scene} training trace: 3 steps of {W}x{H}x{spp} spp in "
          f"{wall:.4f} s under the profiler "
          f"({W * H * spp * 3 / wall / 1e6:.1f} Msamples/s)", flush=True)
    print(f"{scene} training trace: device us by kernel",
          json.dumps(by_name), flush=True)
    print(f"{scene} training trace: forward kernel {kern['forward'] / 1e3:.3f}"
          f" ms ({kern['forward'] / total:.4f} of device time), gradient "
          f"kernel {kern['gradient'] / 1e3:.3f} ms "
          f"({kern['gradient'] / total:.4f}); device busy {busy / 1e3:.3f} "
          f"ms, idle share of the steps' wall {1.0 - busy / 1e6 / wall:.4f}",
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
