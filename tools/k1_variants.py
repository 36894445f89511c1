#!/usr/bin/env python3
"""Make the timing copies of pathtracer_tpu_torch that chip_smoke.py times
the forward megakernel (K1 and its instantiations) against (`--k1-split
DIR`, `--ab-parent DIR`).

    python3 tools/k1_variants.py VARIANT SRC DST

SRC and DST are directories holding a pathtracer_tpu_torch package (a
checkout, or `git archive <commit> pathtracer_tpu_torch` unpacked under the
git-ignored build/); DST/pathtracer_tpu_torch is replaced by a copy of
SRC's with the variant's edits. Each edit must find its text exactly once,
or the script fails.

The split of the bounce and its object loop, and the candidates of its
redesign (`fastdiv` changes the bits; the copies are for timing, and the
others keep them):

- fastdiv: every `/` of the object tests (plane, sphere, cylinder and the
  slab of the box and of a GROUP's pretest) as `__fdividef`, an
  approximate reciprocal and a multiply: what the loop's IEEE divisions
  cost.
- filter: the object loop with the filter (plane_skip, round_skip, which
  filter_check holds to the exact tests): a plane's, sphere's or
  cylinder's test skipped where it cannot give a t below the running
  winner's (nearest_hit) or max(bt, cut) (object_t, the shadow query's);
  bit-equal, but slower on the card (PERF.md §6, PR 12, where the same
  edit was timed on the tree before the 16-byte rows).
- draws: the roulette's four draws taken where they are read (the
  reflection draw where the object reflects, the Schlick draw on a thin
  shell or a solid refractor, the hemisphere's two on a diffuse bounce)
  and not at every bounce.
- sincos: the hemisphere's cosf and sinf of one angle as one sincosf
  (light_sincos, which the light point takes).
- rows16 (for a tree before them): the object rows staged in shared
  memory at a 48-float stride (16-byte aligned) and the inverse's rows
  read as float4, one 16-byte load a row, in every kernel (the
  intersect-only kernel too, which the shipped design leaves on the
  45-float rows); the global table and its packing stay as they are.

The launch shape of the forward instantiations (the per-thread walk's
launches; the packet walks keep 128 threads a block):

- threads64, threads256: 64 or 256 threads a forward block.
- blocksN (N = 1..16): the forward entry's __launch_bounds__ asks for N
  blocks of 128 threads an SM.
"""
from __future__ import annotations

import re
import shutil
import sys
from pathlib import Path

PKG = "pathtracer_tpu_torch"
CU = "csrc/megakernel.cu"

# ---- fastdiv ----------------------------------------------------------------

FASTDIV = [
    ("    t1 = (mn - o) / d;\n    t2 = (mx - o) / d;\n",
     "    t1 = __fdividef(mn - o, d);\n    t2 = __fdividef(mx - o, d);\n"),
    ("  const float t = -oy / dy;\n",
     "  const float t = __fdividef(-oy, dy);\n"),
    ("  const float t_mid = -(ox * dx + oy * dy + oz * dz) / a;\n",
     "  const float t_mid = __fdividef(-(ox * dx + oy * dy + oz * dz), a);\n"),
    ("  if (!(perp2 < 1.0f)) return kBig;\n"
     "  const float dt = sqrtf((1.0f - perp2) / a);\n",
     "  if (!(perp2 < 1.0f)) return kBig;\n"
     "  const float dt = sqrtf(__fdividef(1.0f - perp2, a));\n"),
    ("  const float t_mid = -(ox * dx + oz * dz) / a;\n",
     "  const float t_mid = __fdividef(-(ox * dx + oz * dz), a);\n"),
    ("  if (!(perp2 <= 1.0f)) return kBig;\n"
     "  const float dt = sqrtf((1.0f - perp2) / a);\n",
     "  if (!(perp2 <= 1.0f)) return kBig;\n"
     "  const float dt = sqrtf(__fdividef(1.0f - perp2, a));\n"),
]

# ---- filter -----------------------------------------------------------------

FILTER = [
    ("""    float t;
    if (type == PLANE) {
      t = plane_t(row_point<kStride>(m, 1, ox, oy, oz),
                  row_vec<kStride>(m, 1, dx, dy, dz), eps);
    } else {
      float tox, toy, toz, tdx, tdy, tdz;
      object_ray<kStride>(m, ox, oy, oz, dx, dy, dz, tox, toy, toz, tdx, tdy,
                          tdz);
      if (type == SPHERE) {
        t = sphere_t(tox, toy, toz, tdx, tdy, tdz, eps);
      } else if (type == CYLINDER) {
        t = cylinder_t(tox, toy, toz, tdx, tdy, tdz, m[32], m[33], eps);
""", """    float t;
    if (type == PLANE) {
      const float qy = row_point<kStride>(m, 1, ox, oy, oz);
      const float qdy = row_vec<kStride>(m, 1, dx, dy, dz);
      t = plane_skip(qy, qdy, h.t) ? kBig : plane_t(qy, qdy, eps);
    } else {
      float tox, toy, toz, tdx, tdy, tdz;
      object_ray<kStride>(m, ox, oy, oz, dx, dy, dz, tox, toy, toz, tdx, tdy,
                          tdz);
      if (type == SPHERE) {
        t = sphere_skip(tox, toy, toz, tdx, tdy, tdz, h.t)
                ? kBig : sphere_t(tox, toy, toz, tdx, tdy, tdz, eps);
      } else if (type == CYLINDER) {
        t = cylinder_skip(tox, toz, tdx, tdz, h.t)
                ? kBig
                : cylinder_t(tox, toy, toz, tdx, tdy, tdz, m[32], m[33], eps);
"""),
    ("""  const int type = p.obj_types[j];
  if (type == PLANE)
    return plane_t(row_point<kObjStride>(m, 1, ox, oy, oz),
                   row_vec<kObjStride>(m, 1, dx, dy, dz), eps);
  float tox, toy, toz, tdx, tdy, tdz;
  object_ray<kObjStride>(m, ox, oy, oz, dx, dy, dz, tox, toy, toz, tdx, tdy,
                         tdz);
  switch (type) {
    case SPHERE: return sphere_t(tox, toy, toz, tdx, tdy, tdz, eps);
    case CYLINDER:
      return cylinder_t(tox, toy, toz, tdx, tdy, tdz, m[32], m[33], eps);
""", """  const int type = p.obj_types[j];
  const float T = fmaxf(bt, cut);  // a t at or above both decides nothing
  if (type == PLANE) {
    const float qy = row_point<kObjStride>(m, 1, ox, oy, oz);
    const float qdy = row_vec<kObjStride>(m, 1, dx, dy, dz);
    return plane_skip(qy, qdy, T) ? kBig : plane_t(qy, qdy, eps);
  }
  float tox, toy, toz, tdx, tdy, tdz;
  object_ray<kObjStride>(m, ox, oy, oz, dx, dy, dz, tox, toy, toz, tdx, tdy,
                         tdz);
  switch (type) {
    case SPHERE:
      return sphere_skip(tox, toy, toz, tdx, tdy, tdz, T)
                 ? kBig : sphere_t(tox, toy, toz, tdx, tdy, tdz, eps);
    case CYLINDER:
      return cylinder_skip(tox, toz, tdx, tdz, T)
                 ? kBig
                 : cylinder_t(tox, toy, toz, tdx, tdy, tdz, m[32], m[33],
                              eps);
"""),
]

# ---- draws ------------------------------------------------------------------

DRAWS = [
    ("""      const uint32_t un = (uint32_t)n, ub = (uint32_t)b;
      const float u_refl = hash_uniform(key, u_elem, 2u, un, ub);
      const float u_schl = hash_uniform(key, u_elem, 3u, un, ub);
      const float u1 = hash_uniform(key, u_elem, 4u, un, ub);
      const float u2 = hash_uniform(key, u_elem, 5u, un, ub);
""", """      // each draw is taken in the branch that reads it: the hash is
      // stateless, so a draw has the same value wherever it is taken
      const uint32_t un = (uint32_t)n, ub = (uint32_t)b;
"""),
    ("      const bool do_reflect = (refl != 0.0f) && (u_refl < refl);\n",
     "      const bool do_reflect =\n"
     "          (refl != 0.0f) && (hash_uniform(key, u_elem, 2u, un, ub) < "
     "refl);\n"),
    ("        thin_pass = schlick(ex, ey, ez, nx, ny, nz, 1.0f, 1.5f) < "
     "u_schl;\n",
     "        thin_pass = schlick(ex, ey, ez, nx, ny, nz, 1.0f, 1.5f) <\n"
     "                    hash_uniform(key, u_elem, 3u, un, ub);\n"),
    ("        do_refract = schlick(ex, ey, ez, nx, ny, nz, n1, n2) < u_schl;\n",
     "        do_refract = schlick(ex, ey, ez, nx, ny, nz, n1, n2) <\n"
     "                     hash_uniform(key, u_elem, 3u, un, ub);\n"),
    ("        // cosine-weighted hemisphere (tracer.cl:348-366)\n",
     "        // cosine-weighted hemisphere (tracer.cl:348-366)\n"
     "        const float u1 = hash_uniform(key, u_elem, 4u, un, ub);\n"
     "        const float u2 = hash_uniform(key, u_elem, 5u, un, ub);\n"),
]

# ---- sincos -----------------------------------------------------------------

SINCOS = [
    ("""        const float cu = cosf(rand1) * rand2s;
        const float cv = sinf(rand1) * rand2s;
""", """        float s1, c1;
        light_sincos(rand1, s1, c1);
        const float cu = c1 * rand2s;
        const float cv = s1 * rand2s;
"""),
]

# ---- rows16 -----------------------------------------------------------------

ROWS16 = [
    ("constexpr int kObjCols = 45;\n",
     "constexpr int kObjCols = 45;\n"
     "// an object row staged in shared memory: its 45 columns and 3 zeros, "
     "so that\n// every row, and each row of its inverse, is 16-byte "
     "aligned\nconstexpr int kObjStride = 48;\n"),
    ("""__device__ __forceinline__ float row_point(const float* m, int r, float x,
                                           float y, float z) {
  return m[4 * r] * x + m[4 * r + 1] * y + m[4 * r + 2] * z + m[4 * r + 3];
}

__device__ __forceinline__ float row_vec(const float* m, int r, float x,
                                         float y, float z) {
  return m[4 * r] * x + m[4 * r + 1] * y + m[4 * r + 2] * z;
}
""", """__device__ __forceinline__ float row_point(const float* m, int r, float x,
                                           float y, float z) {
  const float4 q = reinterpret_cast<const float4*>(m)[r];
  return q.x * x + q.y * y + q.z * z + q.w;
}

__device__ __forceinline__ float row_vec(const float* m, int r, float x,
                                         float y, float z) {
  const float4 q = reinterpret_cast<const float4*>(m)[r];
  return q.x * x + q.y * y + q.z * z;
}
"""),
    ("    const float* m = s_obj + j * kObjCols;\n    const int type",
     "    const float* m = s_obj + j * kObjStride;\n    const int type"),
    ("object_ray(s_obj + h.w * kObjCols,",
     "object_ray(s_obj + h.w * kObjStride,"),
    ("  const float* m = s_obj + j * kObjCols;\n  const int type",
     "  const float* m = s_obj + j * kObjStride;\n  const int type"),
    ("""  extern __shared__ float smem[];
  float* s_obj = smem;
  float* s_cam = s_obj + p.n_obj * kObjCols;
""", """  extern __shared__ __align__(16) float smem[];
  float* s_obj = smem;
  float* s_cam = s_obj + p.n_obj * kObjStride;
"""),
    ("""  for (int i = threadIdx.x; i < p.n_obj * kObjCols; i += blockDim.x)
    s_obj[i] = p.obj[i];
""", """  for (int i = threadIdx.x; i < p.n_obj * kObjStride; i += blockDim.x) {
    const int o = i / kObjStride, c = i - o * kObjStride;
    s_obj[i] = c < kObjCols ? p.obj[o * kObjCols + c] : 0.0f;
  }
"""),
    ("const float* wm = s_obj + w * kObjCols;",
     "const float* wm = s_obj + w * kObjStride;"),
    ("const float* lm = s_obj + l * kObjCols;",
     "const float* lm = s_obj + l * kObjStride;"),
    ("""              er = s_obj[id * kObjCols + 27];
              eg = s_obj[id * kObjCols + 28];
              eb = s_obj[id * kObjCols + 29];
""", """              er = s_obj[id * kObjStride + 27];
              eg = s_obj[id * kObjStride + 28];
              eb = s_obj[id * kObjStride + 29];
"""),
    ("sizeof(float) * (size_t)(p.n_obj * (kObjCols + (kGrad",
     "sizeof(float) * (size_t)(p.n_obj * (kObjStride + (kGrad"),
    ("""  extern __shared__ float smem[];
  for (int i = threadIdx.x; i < p.n_obj * kObjCols; i += blockDim.x)
    smem[i] = p.obj[i];
""", """  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < p.n_obj * kObjStride; i += blockDim.x) {
    const int o = i / kObjStride, c = i - o * kObjStride;
    smem[i] = c < kObjCols ? p.obj[o * kObjCols + c] : 0.0f;
  }
"""),
    ("const size_t smem = sizeof(float) * (size_t)(n_obj * kObjCols);",
     "const size_t smem = sizeof(float) * (size_t)(n_obj * kObjStride);"),
    ("(size_t)(n_obj * (kObjCols + (tex ? kTexRow : 0)) + kCamCols);",
     "(size_t)(n_obj * (kObjStride + (tex ? kTexRow : 0)) + kCamCols);"),
    ("sizeof(float) * (size_t)(n_obj *\n"
     "                                                                kObjCols),",
     "sizeof(float) * (size_t)(n_obj *\n"
     "                                                                kObjStride),"),
]

# ---- the launch shape ------------------------------------------------------------

FWD_BOUNDS = "__global__ void __launch_bounds__(kThreads) megakernel(Params p) {"
FWD_CONSTS = "constexpr int kThreads = 128;\n"
FWD_LAUNCH = [
    ("  const int threads = kGrad ? kGradThreads : kThreads;\n",
     "  const int threads = kGrad ? kGradThreads : kFwdThreads;\n"),
    ("""        megakernel<true, false, kTex, kF32, kNee>
            <<<blocks, kThreads, smem, s>>>(p);
      else
        megakernel<false, false, kTex, kF32, kNee>
            <<<blocks, kThreads, smem, s>>>(p);
""", """        megakernel<true, false, kTex, kF32, kNee>
            <<<blocks, kFwdThreads, smem, s>>>(p);
      else
        megakernel<false, false, kTex, kF32, kNee>
            <<<blocks, kFwdThreads, smem, s>>>(p);
"""),
]


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"the text {old[:60]!r} is there {text.count(old)} "
                         "times, not once")
    return text.replace(old, new)


def _apply(edits):
    def fn(text):
        for old, new in edits:
            text = _replace(text, old, new)
        return text
    return fn


def _shape(threads: int, blocks: int = 0):
    """threads a forward block (the packet walks keep kThreads) and, unless
    0, the blocks an SM the forward entry's __launch_bounds__ asks for."""
    consts = FWD_CONSTS + f"constexpr int kFwdThreads = {threads};\n"
    bound = max(threads, 128)
    bounds = ("__global__ void __launch_bounds__("
              + (f"{bound}, {blocks}" if blocks else f"{bound}")
              + ") megakernel(Params p) {")
    return _apply([(FWD_CONSTS, consts), (FWD_BOUNDS, bounds)] + FWD_LAUNCH)


def edits(variant: str):
    """{file under the package: function of its text} of a variant."""
    simple = {"fastdiv": FASTDIV, "filter": FILTER, "draws": DRAWS,
              "sincos": SINCOS, "rows16": ROWS16}
    if variant in simple:
        return {CU: _apply(simple[variant])}
    m = re.fullmatch(r"threads(64|256)", variant)
    if m:
        return {CU: _shape(int(m.group(1)))}
    m = re.fullmatch(r"blocks(\d+)", variant)
    if m and 1 <= int(m.group(1)) <= 16:
        return {CU: _shape(128, int(m.group(1)))}
    raise SystemExit(__doc__)


def make(variant: str, src: str, dst: str) -> Path:
    """Copy SRC's package under DST and apply the variant's edits."""
    todo = edits(variant)
    out = Path(dst) / PKG
    tmp = Path(dst) / (PKG + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    shutil.copytree(Path(src) / PKG, tmp,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, fn in todo.items():
        path = tmp / rel
        path.write_text(fn(path.read_text()))
    if out.exists():
        shutil.rmtree(out)
    tmp.rename(out)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        raise SystemExit(__doc__)
    print(make(*argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
