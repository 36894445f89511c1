#!/usr/bin/env python3
"""Make the timing copies of pathtracer_tpu_torch that chip_smoke.py times
the intersect-only kernel (K5) against (`--k5-split DIR`, `--ab-parent
DIR`, `--ab-chain A,B`).

    python3 tools/k5_variants.py VARIANT[+VARIANT...] SRC DST

SRC and DST are directories holding a pathtracer_tpu_torch package (a
checkout, or `git archive <commit> pathtracer_tpu_torch` unpacked under the
git-ignored build/); DST/pathtracer_tpu_torch is replaced by a copy of
SRC's with the variants' edits, in the order given. SRC = DST edits a tree
in place. `no-VARIANT` undoes a variant's edits (a tree that has it, e.g.
one where it shipped). Each edit must find its text exactly once, or the
script fails.

Step 0, the split of the kernel before its redesign (on the tree of
commit ee563d0, whose launcher and kernel they edit; both change the bits
and are for timing):

- global-rows: the object rows read from the global table instead of
  staged in shared memory by every block (no copy, no __syncthreads).
- t-only: only t and the winner stored (the object-space ray, the
  triangle flag, normal, color and slot not written: the wrapper returns
  what the buffers held).

The candidates of the redesign (PERF.md §6, PR 16), each bit-equal, on
the tree that holds the prepared launcher:

- k5-1 (shipped: the tree has it, so `no-k5-1` makes the copy without
  it): on a scene without groups the kernel stores neither the triangle
  normal and color rows nor the slot and the flag; the wrapper returns
  them as stride-0 views of one zero (and of -1, and of False), on which
  an in-place write raises. Without it the buffers are f32 [13, n] and
  i32 [3, n] on every scene and the kernel stores the constants.
- k5-2 (refused, +11 to +18%): a grid of the blocks that fit on the card
  at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), each block
  staging the object rows once and looping over its rays 128 at a time.
- capN (N = 9..16; 10, 12 and 16 refused, +8% to +61% on the meshes):
  the kernel's __launch_bounds__ asks for N blocks of 128 threads an SM,
  which caps the mesh instantiation's registers (K5-3(a); 56 registers
  allow 8) and spills.
- k5-3b (refused, +4 to +18% on `teapot`): on a scene with groups and
  the per-thread walk, two passes: intersect_sort answers the rays that
  walk no group (nearest_hit<kDefer> stops at the first group whose
  pretest passes) and queues the others a warp at a time;
  intersect_walks runs the queued rays' whole nearest hit, 32 to a warp.
  The queue is a fourth row of the integers, its count after the flags.
"""
from __future__ import annotations

import re
import shutil
import sys
from pathlib import Path

PKG = "pathtracer_tpu_torch"
CU = "csrc/megakernel.cu"
PY = "render/megakernel.py"

# ---- Step 0 (the tree before the redesign) ---------------------------------

GLOBAL_ROWS = [(CU, """\
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < p.n_obj * kObjCols; i += blockDim.x)
    smem[i] = p.obj[i];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
""", """\
  const float* smem = p.obj;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
""")]

T_ONLY = [(CU, """\
  o[n] = miss ? ray[0] : h.lox;
  o[2 * n] = miss ? ray[1] : h.loy;
  o[3 * n] = miss ? ray[2] : h.loz;
  o[4 * n] = miss ? ray[3] : h.ldx;
  o[5 * n] = miss ? ray[4] : h.ldy;
  o[6 * n] = miss ? ray[5] : h.ldz;
  o[7 * n] = on_tri ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[(8 + k) * n] = nrm[k];
    o[(11 + k) * n] = col[k];
  }
  r.idx[i] = miss ? 0 : h.w;
  slot[i] = on_tri ? h.tri : -1;
""", """\
  r.idx[i] = miss ? 0 : h.w;
""")]

# ---- K5-1: no stores of constant zeros -------------------------------------

K5_1 = [(CU, """\
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[(7 + k) * n] = nrm[k];
    o[(10 + k) * n] = col[k];
  }
  r.idx[i] = miss ? 0 : h.w;
  tri.slot[i] = on_tri ? h.tri : -1;
  tri.is_tri[i] = on_tri ? 1 : 0;
}
""", """\
  r.idx[i] = miss ? 0 : h.w;
  if constexpr (kMesh) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[(7 + k) * n] = nrm[k];
      o[(10 + k) * n] = col[k];
    }
    tri.slot[i] = on_tri ? h.tri : -1;
    tri.is_tri[i] = on_tri ? 1 : 0;
  }
}
"""), (CU, """\
  tri = TriOut{ints + n, reinterpret_cast<uint8_t*>(ints + 2 * n)};
""", """\
  tri = mesh ? TriOut{ints + n, reinterpret_cast<uint8_t*>(ints + 2 * n)}
             : TriOut{nullptr, nullptr};
"""), (PY, " else 13, n)", " else 7, n)"), (PY, " else 3, n)", " else 1, n)"),
    (PY, """\
    if True:
        nx, ny, nz, cr, cg, cb = tri""", """\
    if tables.mesh:
        nx, ny, nz, cr, cg, cb = tri""")]

# ---- K5-3(b): the walks in full warps ---------------------------------------

K5_3B = [(CU, """\
// Ray i: nearest_hit, then the outputs of _make_intersect_kernel
""", """\
template <bool kMesh>
__device__ __forceinline__ void store_hit(const Params& p, const Rays& r,
                                          const TriOut& tri, int i,
                                          const float (&ray)[6],
                                          const Hit& h);

// Ray i: nearest_hit, then the outputs of _make_intersect_kernel
"""), (CU, """\
  if (i >= r.n) return;
  const bool miss = h.w < 0;
""", """\
  if (i >= r.n) return;
  store_hit<kMesh>(p, r, tri, i, ray, h);
}

// Ray i's outputs for its hit h.
template <bool kMesh>
__device__ __forceinline__ void store_hit(const Params& p, const Rays& r,
                                          const TriOut& tri, int i,
                                          const float (&ray)[6],
                                          const Hit& h) {
  const bool miss = h.w < 0;
"""), (CU, """\
// The intersect-only kernel on a walk of launch_walk.
struct IntersectLaunch {
""", """\
// K5 on a scene with groups, per-thread walk, in two passes so that the
// walks run in full warps (a walking warp held about two walking lanes on
// `teapot`): the first pass answers every ray that walks no group (its
// object loop stops at the first group whose pretest passes, nearest_hit
// kDefer) and queues the others, a warp's at once (one atomic on the
// queue's count); the second runs intersect_ray on the queued rays, 32 to
// a warp. Each ray's answer is the one-pass kernel's: a ray that walks no
// group takes the same object loop, a queued one the whole of it.
template <int kLeaf>
__global__ void __launch_bounds__(kThreads) intersect_sort(
    Params p, Rays r, TriOut tri, int* queue, int* count) {
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < p.n_obj * kObjCols; i += blockDim.x)
    smem[i] = p.obj[i];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool walks = false;
  if (i < r.n) {
    const float ray[6] = {r.ox[i], r.oy[i], r.oz[i], r.dx[i], r.dy[i],
                          r.dz[i]};
    const Hit h = nearest_hit<true, WALK_THREAD, kLeaf, kObjCols, true>(
        p, smem, ray[0], ray[1], ray[2], ray[3], ray[4], ray[5]);
    walks = h.w == kDeferred;
    if (!walks) store_hit<true>(p, r, tri, i, ray, h);
  }
  const unsigned lanes = __ballot_sync(0xffffffffu, walks);
  if (lanes == 0u) return;
  const int lane = threadIdx.x & 31;
  const int first = __ffs(lanes) - 1;
  int base = 0;
  if (lane == first) base = atomicAdd(count, __popc(lanes));
  base = __shfl_sync(0xffffffffu, base, first);
  if (walks) queue[base + __popc(lanes & ((1u << lane) - 1u))] = i;
}

template <int kLeaf>
__global__ void __launch_bounds__(kThreads) intersect_walks(
    Params p, Rays r, TriOut tri, const int* queue, const int* count) {
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < p.n_obj * kObjCols; i += blockDim.x)
    smem[i] = p.obj[i];
  __syncthreads();
  const int m = *count;
  for (int k = blockIdx.x * kThreads + threadIdx.x; k < m;
       k += gridDim.x * kThreads)
    intersect_ray<true, WALK_THREAD, kLeaf>(p, r, tri, smem, queue[k]);
}

// The blocks of `kernel` that fit on the card at once, with the most
// shared memory a launch of it asks for.
template <class K>
int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per, kernel, kThreads, sizeof(float) * kMaxObjects * kObjCols);
  return per * sms > 0 ? per * sms : 1;
}

// The intersect-only kernel on a walk of launch_walk.
struct IntersectLaunch {
"""), (CU, """\
template <bool kMesh, int kWalk = WALK_THREAD, int kLeaf = LEAF_SIMT,
          int kStride = kObjStride>
__device__ __forceinline__ Hit nearest_hit(const Params& p,""", """\
template <bool kMesh, int kWalk = WALK_THREAD, int kLeaf = LEAF_SIMT,
          int kStride = kObjStride, bool kDefer = false>
__device__ __forceinline__ Hit nearest_hit(const Params& p,"""), (CU, """\
          if (gtmin <= gtmax && gtmax > eps && gtmin < h.t) {
            t = walk_group<kLeaf>(p, p.group_root[j], p.group_end[j], tox,
                                  toy, toz, tdx, tdy, tdz, h.t, g_slot, g_u,
                                  g_v);
          }""", """\
          if (gtmin <= gtmax && gtmax > eps && gtmin < h.t) {
            if constexpr (kDefer) {
              h.w = kDeferred;  // the ray walks: the caller walks it later
              return h;
            } else {
              t = walk_group<kLeaf>(p, p.group_root[j], p.group_end[j], tox,
                                    toy, toz, tdx, tdy, tdz, h.t, g_slot,
                                    g_u, g_v);
            }
          }"""), (CU, """\
constexpr int kMaxObjects = 64;  // type codes travel in the launch params
""", """\
constexpr int kMaxObjects = 64;  // type codes travel in the launch params
constexpr int kDeferred = -2;    // nearest_hit<kDefer>: a group to walk
"""), (CU, """\
  if (blocks > 0) {
    if (mesh)
      intersect<true><<<blocks, kThreads, smem, s>>>(p, r, tri);
    else
      intersect<false><<<blocks, kThreads, smem, s>>>(p, r, tri);
  }
  return (int)cudaGetLastError();
}
""", """\
  if (blocks > 0 && mesh && n >= 2) {
    // the queue is the integers' fourth row, its count the i32 after the
    // flags in the third
    int* queue = r.idx + 3 * (size_t)n;
    int* count = reinterpret_cast<int*>(tri.is_tri + ((n + 3) & ~3));
    static const int fit = resident_blocks(intersect_walks<LEAF_SIMT>);
    cudaMemsetAsync(count, 0, sizeof(int), s);
    intersect_sort<LEAF_SIMT><<<blocks, kThreads, smem, s>>>(p, r, tri,
                                                            queue, count);
    intersect_walks<LEAF_SIMT><<<blocks < fit ? blocks : fit, kThreads,
                                 smem, s>>>(p, r, tri, queue, count);
  } else if (blocks > 0) {
    if (mesh)
      intersect<true><<<blocks, kThreads, smem, s>>>(p, r, tri);
    else
      intersect<false><<<blocks, kThreads, smem, s>>>(p, r, tri);
  }
  return (int)cudaGetLastError();
}
"""), (PY, "(3 if mesh", "(4 if mesh"), (PY, """\
        idx, slot, flag = i.unbind(0)
""", """\
        idx, slot, flag, _ = i.unbind(0)
""")]

# ---- K5-2: a grid of the resident blocks, the rows staged once a block -----

K5_2 = [(CU, """\
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (kWalk == WALK_THREAD && i >= r.n) return;
  intersect_ray<kMesh, kWalk, kLeaf>(p, r, tri, smem, i);
}
""", """\
  __syncthreads();
  for (int base = blockIdx.x * kThreads; base < r.n;
       base += gridDim.x * kThreads) {
    const int i = base + threadIdx.x;
    if (kWalk != WALK_THREAD || i < r.n)
      intersect_ray<kMesh, kWalk, kLeaf>(p, r, tri, smem, i);
  }
}

// The blocks of `kernel` that fit on the card at once.
template <class K>
int resident_blocks(K kernel, size_t smem) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, smem);
  return per * sms > 0 ? per * sms : 1;
}
"""), (CU, """\
    const int blocks = (r.n + kThreads - 1) / kThreads;
    if (blocks > 0)
      intersect<true, kWalk, kLeaf><<<blocks, kThreads, smem, stream>>>(
          p, r, tri);
""", """\
    const int all = (r.n + kThreads - 1) / kThreads;
    const int fit = resident_blocks(intersect<true, kWalk, kLeaf>, smem);
    const int blocks = all < fit ? all : fit;
    if (blocks > 0)
      intersect<true, kWalk, kLeaf><<<blocks, kThreads, smem, stream>>>(
          p, r, tri);
"""), (CU, """\
  if (blocks > 0) {
    if (mesh)
      intersect<true><<<blocks, kThreads, smem, s>>>(p, r, tri);
    else
      intersect<false><<<blocks, kThreads, smem, s>>>(p, r, tri);
  }
""", """\
  if (blocks > 0) {
    const int fit = mesh ? resident_blocks(intersect<true>, smem)
                         : resident_blocks(intersect<false>, smem);
    const int grid = blocks < fit ? blocks : fit;
    if (mesh)
      intersect<true><<<grid, kThreads, smem, s>>>(p, r, tri);
    else
      intersect<false><<<grid, kThreads, smem, s>>>(p, r, tri);
  }
""")]


def _cap(blocks: int):
    return [(CU, """\
__global__ void __launch_bounds__(kThreads) intersect(Params p, Rays r,
                                                      TriOut tri) {
""", f"""\
__global__ void __launch_bounds__(kThreads, {blocks}) intersect(
    Params p, Rays r, TriOut tri) {{
""")]


SIMPLE = {"global-rows": GLOBAL_ROWS, "t-only": T_ONLY, "k5-1": K5_1,
          "k5-2": K5_2, "k5-3b": K5_3B}


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"the text {old[:60]!r} is there {text.count(old)} "
                         "times, not once")
    return text.replace(old, new)


def edits(variant: str):
    """[(file under the package, old text, new text)] of a variant;
    `no-VARIANT` gives the edits undone, in reverse order."""
    if variant.startswith("no-"):
        return [(f, new, old) for f, old, new in edits(variant[3:])[::-1]]
    if variant in SIMPLE:
        return SIMPLE[variant]
    m = re.fullmatch(r"cap(\d+)", variant)
    if m and 9 <= int(m.group(1)) <= 16:
        return _cap(int(m.group(1)))
    raise SystemExit(__doc__)


def make(variants: str, src: str, dst: str) -> Path:
    """Copy SRC's package under DST and apply the variants' edits."""
    todo = [e for v in variants.split("+") for e in edits(v)]
    out = Path(dst) / PKG
    tmp = Path(dst) / (PKG + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    shutil.copytree(Path(src) / PKG, tmp,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in todo:
        path = tmp / rel
        path.write_text(_replace(path.read_text(), old, new))
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
