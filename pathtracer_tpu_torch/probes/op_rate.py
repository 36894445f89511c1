"""The op-rate probe (P2): how many f32 operations a second a kernel issues,
per kind, on the card (csrc/probes.cu; the counterpart of the JAX package's
tools/vpu_peak_probe.py, whose five variants it keeps, with the kinds the
megakernel's own mix spends its time on under -fmad=false: separate adds,
IEEE division and square root, sin and cos).

Each of n threads runs `iters` iterations of a variant's unrolled body
(OPS_PER_ITER operations a thread an iteration, counted as chip_smoke.py
counts a bound's: an FMA is one operation, a compare and a select count in
CMP_SEL, where they are the point). A rate is the marginal one: the same
launch at iters and 2 iters, timed by CUDA events (best of `reps`), so the
launch's fixed cost cancels.

    python -m pathtracer_tpu_torch.probes.op_rate [variant ...]
    python -m pathtracer_tpu_torch.probes.op_rate --device cpu

On the CPU (`--device cpu`) it runs the plain PyTorch version of each
variant at a small size, the numbers of which are the CPU's and not the
card's.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import time

import numpy as np
import torch

from ..render import _build

VARIANTS = ("fma_dep", "fma_par8", "mul_par8", "add_par8", "cmp_sel",
            "leafmix", "div_par8", "sqrt_par8", "sincos")
UNROLL = 32
# operations a thread an iteration (csrc/probes.cu): LEAFMIX 35 a triangle
# and 7 an iteration; CMP_SEL a compare, multiply, add and select a pair
OPS_PER_ITER = {v: UNROLL for v in VARIANTS}
OPS_PER_ITER.update(cmp_sel=4 * UNROLL // 2, leafmix=35 * UNROLL + 7)
# iterations of a timed launch of THREADS threads (doubled for the second):
# about 5-20 ms a launch on an H100
ITERS = {"fma_dep": 2000, "fma_par8": 4000, "mul_par8": 4000,
         "add_par8": 4000, "cmp_sel": 2000, "leafmix": 100, "div_par8": 400,
         "sqrt_par8": 400, "sincos": 200}
THREADS = 1 << 20

_SIGNATURES = {"pt_op_rate_launch": (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p], ctypes.c_int)}

# the f32 constants of csrc/probes.cu
_C = {k: float(np.float32(v)) for k, v in (
    ("m", 1.000001), ("mul_sel", 0.9999), ("add_sel", 0.0001),
    ("add", 2.0 ** -10), ("tenth", 0.1), ("hundredth", 0.01),
    ("thousandth", 0.001), ("eps", 1e-4))}
# DIV_PAR8's numerator at unrolled position k: m, 2m, 4m, 2m by k >> 3
_DIV_NUM = tuple(_C["m"] * s for s in (1.0, 2.0, 4.0, 2.0))
# the variants whose plain version does the kernel's IEEE f32 operations in
# the kernel's order (the FMA as an f64 multiply-add, exact for these chains,
# rounded once): held bit for bit. sin/cos (libm against CUDA's) and leafmix
# (constant coefficients the compiler folds) keep a tolerance.
EXACT = tuple(v for v in VARIANTS if v not in ("sincos", "leafmix"))
REL_TOL = 1e-5


def run_plain(variant: str, x: torch.Tensor, iters: int) -> torch.Tensor:
    """The plain PyTorch version of a variant: the kernel's result bit for
    bit for the EXACT variants (on the card, where torch's square root is
    IEEE), within REL_TOL for the others."""
    f32 = torch.float32
    c = [x + _C["hundredth"] * float(j) for j in range(8)]
    if variant == "leafmix":
        ray0 = (x, x + 0.1, x - 1.5, x * _C["hundredth"], x * 0.02, x + 1.0)
        bt = torch.zeros_like(x)
        gnx = torch.zeros_like(x)
        for _ in range(iters):
            e = gnx * 1e-30
            ox, oy, oz, dx, dy, dz = (a + e for a in ray0)
            for s in range(UNROLL):
                co = [float(np.float32(
                    np.float32(_C["tenth"] * float((s + k) % 7 + 1))
                    + np.float32(_C["thousandth"] * float(s))))
                      for k in range(12)]
                pxx, pyy, pzz = ox - co[0], oy - co[1], oz - co[2]
                den = dx * co[3] + dy * co[4] + dz * co[5]
                num_t = -(pxx * co[3] + pyy * co[4] + pzz * co[5])
                ok = torch.abs(den) >= _C["eps"]
                t = num_t * (1.0 / torch.where(ok, den, 1.0))
                hx, hy, hz = pxx + t * dx, pyy + t * dy, pzz + t * dz
                u = hx * co[6] + hy * co[7] + hz * co[8]
                v = hx * co[9] + hy * co[10] + hz * co[11]
                bt = bt + t * u
                gnx = gnx + v
        return bt + gnx
    for _ in range(iters):
        for k in range(UNROLL):
            j = k & 7
            if variant in ("fma_dep", "fma_par8"):
                i = 0 if variant == "fma_dep" else j
                c[i] = (c[i].double() * _C["m"] + 0.5).to(f32)
            elif variant == "mul_par8":
                c[j] = c[j] * _C["m"]
            elif variant == "add_par8":
                c[j] = c[j] + _C["add"]
            elif variant == "cmp_sel":
                if k % 2 == 0:
                    c[j] = torch.where(c[j] > c[(j + 1) & 7],
                                       c[j] * _C["mul_sel"],
                                       c[j] + _C["add_sel"])
            elif variant == "div_par8":
                c[j] = torch.full_like(c[j], _DIV_NUM[k >> 3]) / c[j]
            elif variant == "sqrt_par8":
                c[j] = torch.sqrt(c[j])
            elif variant == "sincos":
                c[j] = torch.cos(c[j]) if j & 1 else torch.sin(c[j])
            else:
                raise ValueError(f"unknown variant {variant!r}")
    s = torch.zeros_like(x)
    for j in range(8):
        s = s + c[j]
    return s


def compare(variant: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """A kernel's output against its plain version's: {"ok", "max_rel",
    "max_abs", "rule"}. The EXACT variants must be equal bit for bit (every
    operation moves its chain by more than one ulp of the output sum, so a
    kernel that skips one differs); sincos and leafmix within REL_TOL."""
    diff = (got - want).abs()
    rel = float((diff / want.abs().clamp(min=1e-30)).max())
    exact = variant in EXACT
    ok = bool(torch.isfinite(got).all()) and (
        torch.equal(got, want) if exact else rel <= REL_TOL)
    return {"ok": ok, "max_rel": rel, "max_abs": float(diff.max()),
            "rule": "bit-equal" if exact else f"rel <= {REL_TOL:g}"}


def run(variant: str, x: torch.Tensor, iters: int) -> torch.Tensor:
    """One launch of `variant` on len(x) threads (CUDA tensors; counted in
    run.launches), or its plain version (CPU tensors)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous f32 [n] tensor")
    if x.device.type != "cuda":
        return run_plain(variant, x, iters)
    lib = _build.load("probes", _SIGNATURES)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.pt_op_rate_launch(
            x.data_ptr(), out.data_ptr(), x.numel(), iters,
            VARIANTS.index(variant),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"op-rate launch failed: CUDA error {err}")
    run.launches += 1
    return out


run.launches = 0


def best_seconds(fn, device, reps: int = 3) -> float:
    """Best of `reps` calls of fn, by CUDA events on the card and the wall
    clock on the CPU."""
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def measure(variant: str, device, threads: int = THREADS,
            iters: int = None, reps: int = 3) -> dict:
    """The marginal rate of `variant` on `device`: {"ops_per_s", "ms" (the
    iters launch), "ms_2x", "threads", "iters", "ops"}."""
    device = torch.device(device)
    iters = iters or ITERS[variant]
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        1.0, 2.0, threads).astype(np.float32)).to(device)
    run(variant, x, 1)  # build and warm up
    t1 = best_seconds(lambda: run(variant, x, iters), device, reps)
    t2 = best_seconds(lambda: run(variant, x, 2 * iters), device, reps)
    ops = threads * iters * OPS_PER_ITER[variant]
    return {"ops_per_s": ops / max(t2 - t1, 1e-12), "ms": t1 * 1e3,
            "ms_2x": t2 * 1e3, "threads": threads, "iters": iters,
            "ops": ops}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; default) or cpu (the plain "
                         "versions, at a small size)")
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device (run the plain versions with --device cpu)")
    threads = args.threads or (THREADS if dev.type == "cuda" else 4096)
    for v in args.variants:
        iters = None if dev.type == "cuda" else 2
        r = measure(v, dev, threads, iters)
        print(json.dumps({"variant": v, "device": str(dev), **r}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
