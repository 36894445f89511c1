"""Why the JAX package's native scene core differs from its NumPy path.

Compiles a copy of `native/scenecore.cpp` (the JAX package's C++ core) into
a temporary directory twice, with its Makefile's flags (`-O3 -mavx2
-mfma`, under which GCC contracts `a*b + c*d` into fused multiply-adds)
and with the same flags plus `-ffp-contract=off`, and holds each build's
BVH and vertex normals against the JAX package's NumPy path on the
size-check mesh (a 16,640-triangle UV sphere, leaf 16). Prints, for each
build, the nodes, slots and normal rows that differ. The port's own core
(pathtracer_tpu_torch/csrc/scenecore.cpp) is built with
`-ffp-contract=off` for this reason.

CPU only; needs g++ with AVX2 and FMA code generation. Run from the root of
the checkout: `python tools/scenecore_fma_check.py`.
"""
import ctypes as ct
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from pathtracer_tpu.assets import uv_sphere_obj  # noqa: E402
from pathtracer_tpu.scene import bvh as jbvh  # noqa: E402
from pathtracer_tpu.scene import objfile as jobj  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "scenecore.cpp")
MAKEFILE_FLAGS = ["-O3", "-mavx2", "-mfma", "-std=c++17", "-fPIC"]
LEAF = 16
_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_int = ct.POINTER(ct.c_int)


def load(path):
    lib = ct.CDLL(path)
    lib.sc_build_bvh.restype = ct.c_void_p
    lib.sc_build_bvh.argtypes = [_f64, _f64, _f64, ct.c_int, ct.c_int]
    lib.sc_bvh_counts.argtypes = [ct.c_void_p, _int, _int]
    lib.sc_bvh_nodes.argtypes = [ct.c_void_p, _f64, _f64, _i32, _i32, _i32]
    lib.sc_bvh_slots.argtypes = [ct.c_void_p, _i32]
    lib.sc_bvh_free.argtypes = [ct.c_void_p]
    lib.sc_parse_obj.restype = ct.c_void_p
    lib.sc_parse_obj.argtypes = [ct.c_char_p, ct.c_char_p, _f64, _f64,
                                 ct.c_int, ct.c_int]
    lib.sc_obj_counts.argtypes = [ct.c_void_p] + [_int] * 4
    lib.sc_obj_tris.argtypes = [ct.c_void_p] + [_f64] * 9 + [_i32]
    lib.sc_obj_free.argtypes = [ct.c_void_p]
    return lib


def native_bvh(lib, p1, p2, p3):
    h = lib.sc_build_bvh(p1, p2, p3, len(p1), LEAF)
    nn, ns = ct.c_int(), ct.c_int()
    lib.sc_bvh_counts(h, ct.byref(nn), ct.byref(ns))
    out = (np.empty((nn.value, 3)), np.empty((nn.value, 3)),
           *(np.empty(nn.value, np.int32) for _ in range(3)))
    lib.sc_bvh_nodes(h, *out)
    slots = np.empty(ns.value, np.int32)
    lib.sc_bvh_slots(h, slots)
    lib.sc_bvh_free(h)
    return out + (slots,)


def native_normals(lib, text):
    h = lib.sc_parse_obj(text.encode(), b"", np.zeros((1, 3)), np.ones(1),
                         0, 1)
    counts = [ct.c_int() for _ in range(4)]
    lib.sc_obj_counts(h, *(ct.byref(c) for c in counts))
    n = counts[0].value
    arrays = [np.empty((n, 3)) for _ in range(8)]
    lib.sc_obj_tris(h, *arrays, np.empty(n), np.empty(n, np.int32))
    lib.sc_obj_free(h)
    return arrays[3]


def main():
    text = uv_sphere_obj(66, 128)
    tris = jobj.parse_obj(text).all_triangles()
    jobj.compute_vertex_normals(tris)     # every triangle, as the core does
    p1, p2, p3 = (np.ascontiguousarray(np.stack([getattr(t, k)[:3]
                                                 for t in tris]))
                  for k in ("p1", "p2", "p3"))
    n1 = np.stack([t.n1[:3] for t in tris])
    want = jbvh._emit_python(np.minimum(np.minimum(p1, p2), p3),
                             np.maximum(np.maximum(p1, p2), p3),
                             (p1 + p2 + p3) / 3.0, len(p1), LEAF)
    with tempfile.TemporaryDirectory() as d:
        for name, extra in (("Makefile flags", []),
                            ("-ffp-contract=off", ["-ffp-contract=off"])):
            lib_path = os.path.join(d, f"lib{len(extra)}.so")
            subprocess.run(["g++", *MAKEFILE_FLAGS, *extra, "-shared", "-o",
                            lib_path, SRC], check=True)
            lib = load(lib_path)
            got = native_bvh(lib, p1, p2, p3)
            same_count = len(got[0]) == len(want[0])
            nodes = int(np.sum(
                (got[0] != want[0]).any(1) | (got[1] != want[1]).any(1)
                | (got[2] != want[2]) | (got[3] != want[3])
                | (got[4] != want[4]))) if same_count else "(count differs)"
            slots = (int(np.sum(got[5] != want[5]))
                     if len(got[5]) == len(want[5]) else "(count differs)")
            rows = int(np.sum((native_normals(lib, text) != n1).any(1)))
            print(f"{name}: {len(p1)} triangles, leaf {LEAF}: {nodes} of "
                  f"{len(want[0])} nodes and {slots} of {len(want[5])} "
                  f"slots differ from the NumPy path; vertex normals: "
                  f"{rows} of {len(n1)} rows differ")


if __name__ == "__main__":
    main()
