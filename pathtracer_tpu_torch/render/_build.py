"""Build and load the hand-written CUDA kernels of this package, and its
host scene core.

The CUDA sources under `pathtracer_tpu_torch/csrc/` (`*.cu`) are compiled
with nvcc for Hopper (sm_90a) into a shared library with a plain C
interface, loaded with ctypes. The host scene core (`csrc/scenecore.cpp`,
bound by `native.py`) is compiled with the host's C++ compiler (`CXX`,
else `c++` or `g++`). Each library goes to `build/kernels/` at the root
of the checkout (listed in .gitignore), named by a hash of the source and
the compiler command, so it is built at first use and rebuilt only when
either changes. A library is written to a file of its own process and
moved into place, so processes that build it at once (parallel test
workers) never load a half-written one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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

# The host scene core must round every operation as the Python path does:
# no multiply and add contracted into one fused operation, no fast-math.
HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")

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


def _cxx() -> str:
    """The host C++ compiler: CXX, else c++ or g++ on the PATH."""
    if os.environ.get("CXX"):
        return os.environ["CXX"]
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found is not None:
            return found
    raise RuntimeError(
        "no C++ compiler (set CXX, or put c++ or g++ on the PATH); the "
        "scene core is built from csrc/scenecore.cpp at first use "
        "(PT_NATIVE=0 selects the Python path instead)")


def _tmp_path(lib: Path) -> Path:
    return lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")


def host_target(name: str, cxx: str) -> Path:
    """The library path of csrc/<name>.cpp built by `cxx` with
    HOST_FLAGS."""
    src = CSRC / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        (cxx,) + HOST_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-host-{digest}.so"


def build_host(name: str) -> Path:
    """Compile csrc/<name>.cpp with the host compiler unless its library
    exists. Returns the library path; raises RuntimeError with the
    compiler's output if the compiler is missing or fails."""
    cxx = _cxx()
    lib = host_target(name, cxx)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _tmp_path(lib)
    src = CSRC / f"{name}.cpp"
    try:
        proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run the C++ compiler {cxx!r}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for {src} (rc={proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


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
        tmp = _tmp_path(lib)
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
        _loaded[key] = _declare(ctypes.CDLL(str(build(name))), signatures)
    return _loaded[key]


def load_host(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cpp with the host compiler,
    declaring its C functions as `load` does."""
    path = build_host(name)
    if path not in _loaded:
        _loaded[path] = _declare(ctypes.CDLL(str(path)), signatures)
    return _loaded[path]


def _declare(lib: ctypes.CDLL, signatures: dict) -> ctypes.CDLL:
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib
