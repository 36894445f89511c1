"""Build and load the hand-written CUDA kernels of this package.

The sources under `pathtracer_tpu_torch/csrc/` are compiled with nvcc for
Hopper (sm_90a) into a shared library with a plain C interface, loaded
with ctypes. The library goes to `build/kernels/` at the root of the
checkout (listed in .gitignore), named by a hash of the source and the
flags, so it is built at first use and rebuilt only when either changes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# -fmad=false: no FMA contraction, so every multiply and add rounds like the
# plain PyTorch version and the JAX reference (a one-ulp change can flip a
# roulette decision). No --use_fast_math: IEEE sqrt and division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built "
            "from source at first use")
    return found


def _target(name: str) -> Path:
    """The library path of csrc/<name>.cu for its source and the flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names) -> list:
    """Compile csrc/<name>.cu for each name whose library for this source
    and these flags does not exist yet, one nvcc each, all started
    together. Returns the library paths; the compiler's output (with ptxas
    register and spill counts) is kept beside each as <lib>.log."""
    libs = [_target(n) for n in names]
    jobs = []
    for name, lib in zip(names, libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        src = CSRC / f"{name}.cu"
        jobs.append((src, lib, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, lib, tmp, proc in jobs:
        out, err = proc.communicate()
        lib.with_suffix(".log").write_text(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src} (rc={proc.returncode}):\n"
                          f"{out}{err}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library for this source and these
    flags exists (build_all of one). Returns the library path."""
    return build_all([name])[0]


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu, declaring each C
    function's (argtypes, restype) from `signatures`. Libraries are kept
    per (name, NVCC_FLAGS), so a probe that sets NVCC_FLAGS selects
    another build of the same source."""
    key = (name, NVCC_FLAGS)
    if key not in _loaded:
        lib = ctypes.CDLL(str(build(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[key] = lib
    return _loaded[key]
