#!/usr/bin/env python3
"""Smoke test of pathtracer_tpu_torch on one CUDA card.

Run from the root of the checkout: `python3 chip_smoke.py`. It builds the
CUDA megakernel from the sources in the checkout, holds it against its
plain PyTorch version on the card at 160x120, renders the `reference`
scene at 1280x960x2048 spp through the CLI (the reference renderer's
benchmark) and checks the image, requires the kernel to be bit-equal to
the plain version on the driver's last 128-spp segment at that size, times
the kernel against the plain version, and prints
one JSON line of kernel results and, last, one JSON line naming the
device. Every failure raises; without a card it exits non-zero before
printing any result. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.geometry import transforms as gx
from pathtracer_tpu_torch.io.raw import read_raw
from pathtracer_tpu_torch.render import _build
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scene import material, pack, shapes
from pathtracer_tpu_torch.scenes import cornell, get_scene

# the test suite's synthetic scene and per-slot rule (jax-free helpers)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from _torch_scenes import (ATOL, MEAN_REL, RTOL, SLOT_FRAC,  # noqa: E402
                           cylinder_scene, port_inputs)

MAIN_MEAN_REL = 0.02         # 2048-spp image vs 8-spp plain render
TILE = (64, 256)             # the driver's tile for primitive scenes


def phase(msg: str) -> None:
    print(msg, flush=True)


def compare(name, sc, cfg, tile, sample_base, dev):
    """Kernel vs plain version on the card, same inputs. Returns the max
    abs error."""
    tabs, meta, _ = port_inputs(sc, cfg, tile, dev)
    seed = (cfg.seed * 7919 + 1, sample_base)
    kw = dict(meta=meta, cfg=cfg, spp=cfg.samples,
              total_samples=cfg.samples + sample_base, tile=tile)
    k = torch.stack(mk.trace_tiles(seed, *tabs, **kw))
    p = torch.stack(mk.trace_tiles_reference(seed, *tabs, **kw))
    torch.cuda.synchronize()
    k, p = k.cpu().numpy(), p.cpu().numpy()
    if not np.isfinite(k).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    frac = float(np.isclose(k, p, atol=ATOL, rtol=RTOL).mean())
    km, pm = k.mean(axis=(1, 2)), p.mean(axis=(1, 2))
    mean_rel = float(np.max(np.abs(km - pm) / np.abs(pm)))
    max_err = float(np.abs(k - p).max())
    phase(f"phase 3: {name}: {frac:.6f} of slot values within atol={ATOL} "
          f"rtol={RTOL} (need {SLOT_FRAC}); mean rel diff {mean_rel:.2e} "
          f"(need <{MEAN_REL}); max abs err {max_err:.3e}")
    if frac < SLOT_FRAC or mean_rel >= MEAN_REL:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return max_err


def timed(fn):
    """(torch.stack(fn()), ms) of one call, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = torch.stack(fn())
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of `fn` on the card, by CUDA events, after one
    warm-up call."""
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


def main() -> int:
    # ---- phase 1: the card ----------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0] if smi else "unknown"
    phase(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("phase 1: no CUDA device visible; nothing to test")
    dev = torch.device("cuda:0")
    phase(f"phase 1: card {card}")

    # ---- phase 2: build the kernel library ------------------------------
    t0 = time.perf_counter()
    lib = _build.build("megakernel")
    phase(f"phase 2: built {lib.name} in {time.perf_counter() - t0:.1f} s")
    log = lib.with_suffix(".log")
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "registers" in line or "spill" in line:
            phase(f"phase 2: ptxas: {line.strip()}")

    # ---- phase 3: kernel vs plain version on the card -------------------
    small = RenderConfig(width=160, height=120, samples=16,
                         samples_per_pass=16)
    dof = small.replace(aperture=0.1, focal_length=1.6)
    cases = [
        ("reference", get_scene("reference", small), small, 0),
        ("transparency_f_light", get_scene("transparency_f_light", small),
         small, 0),
        ("cylinder", cylinder_scene(small, gx, material, shapes, pack,
                                    cornell), small, 0),
        ("reference dof", get_scene("reference", dof), dof, 16),
    ]
    errs = []
    for name, sc, cfg, base in cases:
        errs.append(compare(name, sc, cfg, TILE, base, dev))

    # ---- phase 4: the main path at the benchmark size -------------------
    W, H, SPP = 1280, 960, 2048
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "experiment.raw")
        metrics = os.path.join(tmp, "metrics.json")
        mk.trace_tiles.launches = 0
        rc = cli.main([
            "--scene", "reference", "--width", str(W), "--height", str(H),
            "--samples", str(SPP), "--raw-output", raw,
            "--output", os.path.join(tmp, "out.png"),
            "--metrics-json", metrics])
        launches = mk.trace_tiles.launches
        if rc != 0:
            raise AssertionError(f"phase 4: cli.main returned {rc}")
        img = read_raw(raw)
        with open(metrics) as f:
            m = json.load(f)
    want = m["segments"]
    phase(f"phase 4: reference {W}x{H}x{SPP}: {m['msamples_per_sec']} "
          f"Msamples/s, render wall {m['wall_s']} s (driver), "
          f"{m['total_wall_s']} s incl. scene setup; {launches} kernel "
          f"launches for {want} segments; card {card}")
    if launches != want or want != 16:
        raise AssertionError("phase 4: the main path did not launch the "
                             "kernel once per segment (16 expected)")
    if img.shape != (H, W, 3) or not np.isfinite(img).all():
        raise AssertionError("phase 4: image is not finite [H, W, 3]")
    left, right = img[H // 2, 5], img[H // 2, W - 6]
    if not (left[0] > left[2] and right[2] > right[0]):
        raise AssertionError(f"phase 4: Cornell walls wrong: {left} {right}")
    cfg8 = RenderConfig(width=W, height=H, samples=8, samples_per_pass=8)
    sc8 = get_scene("reference", cfg8)
    tabs8, meta8, pid = port_inputs(sc8, cfg8, TILE, dev)
    kw8 = dict(meta=meta8, cfg=cfg8, spp=8, total_samples=8, tile=TILE)
    ref = torch.stack(mk.trace_tiles_reference((1, 0), *tabs8, **kw8), -1)
    ref = mk.untile_image(ref.reshape(-1, 3).cpu().numpy(), pid, W, H) / 8.0
    rel = np.abs(img.reshape(-1, 3).mean(0) - ref.mean(0)) / ref.mean(0)
    phase(f"phase 4: image mean {img.reshape(-1, 3).mean(0)} vs plain "
          f"8-spp {ref.mean(0)}: rel diff {rel.max():.4f} "
          f"(need <{MAIN_MEAN_REL}); walls {left} {right}")
    if rel.max() >= MAIN_MEAN_REL:
        raise AssertionError("phase 4: image mean off the plain render")

    # the driver's last segment again, kernel vs plain version slot by
    # slot: the shapes, seed vector and sample base the main path used
    cfg = RenderConfig(width=W, height=H, samples=SPP)
    chunk = cfg.samples_per_pass
    seg_spp = m["samples"] // (W * H) // want          # 128 (PT_SEG_SPP)
    c0 = (SPP - seg_spp) // chunk
    seed = (cfg.seed * 7919 + c0 + 1, c0 * chunk)
    tabs, meta, _ = port_inputs(get_scene("reference", cfg), cfg, TILE, dev)
    kw = dict(meta=meta, cfg=cfg, spp=seg_spp, total_samples=SPP, tile=TILE)
    k = torch.stack(mk.trace_tiles(seed, *tabs, **kw)).cpu().numpy()
    p, p_ms = timed(lambda: mk.trace_tiles_reference(seed, *tabs, **kw))
    p = p.cpu().numpy()
    frac = float(np.isclose(k, p, atol=ATOL, rtol=RTOL).mean())
    bit_eq = float((k == p).mean())
    seg_err = float(np.abs(k - p).max())
    phase(f"phase 4: segment seed {seed} x {seg_spp} spp of {SPP} at "
          f"{W}x{H}: kernel vs plain bit-equal on {bit_eq:.6f} of "
          f"{k.size} slot values, {frac:.6f} within atol={ATOL} "
          f"rtol={RTOL}; max abs err {seg_err:.3e}")
    if not np.isfinite(k).all() or bit_eq != 1.0:
        raise AssertionError("phase 4: kernel differs from the plain "
                             "version on the main path's segment")
    errs.append(seg_err)

    # ---- phase 5: kernel vs plain time ----------------------------------
    k_ms = cuda_ms(lambda: mk.trace_tiles(seed, *tabs, **kw), 5)
    k8_ms = cuda_ms(lambda: mk.trace_tiles((1, 0), *tabs8, **kw8), 10)
    p8_ms = cuda_ms(lambda: mk.trace_tiles_reference((1, 0), *tabs8, **kw8),
                    2)
    phase(f"phase 5: {W}x{H}x{seg_spp} spp (one segment): kernel "
          f"{k_ms:.3f} ms ({W * H * seg_spp / k_ms / 1e3:.1f} Msamples/s), "
          f"plain {p_ms:.3f} ms; card {card}")
    phase(f"phase 5: {W}x{H}x8 spp: kernel {k8_ms:.3f} ms "
          f"({W * H * 8 / k8_ms / 1e3:.1f} Msamples/s), plain {p8_ms:.3f} "
          f"ms; card {card}")

    print(json.dumps({"kernels": [{
        "name": "megakernel", "route": "cuda",
        "source": "pathtracer_tpu_torch/csrc/megakernel.cu",
        "replaces": "pathtracer_tpu/render/pallas_kernel.py:1903",
        "launches": launches, "max_abs_err": max(errs),
        "bit_equal_frac": bit_eq, "slot_frac_within_tol": frac,
        "shape": f"{W}x{H}x{seg_spp}spp", "ms": k_ms, "plain_ms": p_ms,
        "ms_8spp": k8_ms, "plain_ms_8spp": p8_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
