#!/usr/bin/env python3
"""Make the timing copies of pathtracer_tpu_torch that chip_smoke.py times
the gradient kernel (K6, K6-tex) against (`--grad-split DIR`,
`--ab-parent DIR`).

    python3 tools/grad_variants.py VARIANT SRC DST

SRC and DST are directories holding a pathtracer_tpu_torch package (a
checkout, or `git archive <commit> pathtracer_tpu_torch` unpacked under the
git-ignored build/); DST/pathtracer_tpu_torch is replaced by a copy of
SRC's with the variant's edits. Each edit must find its text exactly once,
or the script fails.

The split of a kernel whose tape is a per-thread array (the kernel before
the shared tape; its gradients are wrong, the copies are for timing):

- replay: the tape's writes, the reverse walk and the adds compiled out;
  the path's mask and hit count are kept alive by an empty `asm volatile`
  that takes them, so the replay's work stays and nothing else does.
- tape: the tape written and kept (one entry of each array read at a
  run-time index after each sample, into an empty asm), no reverse walk.
- walk: the full reverse walk, each add going to an empty asm that takes
  its address and value (a register, no memory operation).

The full kernel is the tree itself. For the kernel with merged adds:

- shared: the tape in shared memory after the tables, thread-minor (word
  w of entry k of thread t at (k words + w) 128 + t), sized by the
  launch's max_bounces, with only what the reverse walk cannot read again
  (the winner and its update bit in one word, cos, the mask, and the
  color fetch's (u, v)): 20 bytes an entry, 28 with texels; the reverse
  walk reads the color again where the forward read it (the object row,
  the triangle's shading record, the texel at the taped (u, v)).
- slim: shared's slim entries in a per-thread array of 16 entries (local
  memory) and no shared memory for them: the place of the tape against
  its size.
- unmerged: no warp merge (each lane adds its own sums) and three scalar
  atomics where one 16-byte atomic adds a row.
- vector: no warp merge, the 16-byte atomics kept.
- blocksN (N = 1..16): the gradient entry's __launch_bounds__ asks for N
  blocks an SM (8: at most 64 registers a thread).
- uncapped: the gradient entry's __launch_bounds__ names no block count.
- threads256, threads64: 256 or 64 threads a gradient block, the blocks
  an SM scaled to keep the register cap (the wrapper's block check with
  it).
"""
from __future__ import annotations

import re
import shutil
import sys
from pathlib import Path

PKG = "pathtracer_tpu_torch"
CU = "csrc/megakernel.cu"

# ---- the split of the per-thread-array tape --------------------------------

TAPE_WRITE = ("      if constexpr (kGrad) {\n        if (!do_refract) {\n"
              "          // tape entry",
              "      // kPacket: every lane enters")
BACKWARD = ("    if constexpr (kGrad) {\n      // ---- this sample's backward "
            "pass", "    acc_r = acc_r + sr;\n")

REPLAY_BACKWARD = """    if constexpr (kGrad) {
      // timing copy: the path kept alive, no tape, no reverse walk
      asm volatile("" ::"f"(mask_r), "f"(mask_g), "f"(mask_b), "r"(n_hits));
    }
"""
TAPE_BACKWARD = """    if constexpr (kGrad) {
      // timing copy: the tape written and kept (one entry read at a
      // run-time index), no reverse walk
      if (nb > 0) {
        const int k = (int)((unsigned)(idx + n) % (unsigned)nb);
        asm volatile("" ::"r"(t_id[k]), "f"(t_cos[k]), "f"(t_m[3 * k]),
                     "f"(t_m[3 * k + 1]), "f"(t_m[3 * k + 2]),
                     "f"(t_c[3 * k]), "f"(t_c[3 * k + 1]),
                     "f"(t_c[3 * k + 2]), "r"(upd_bits), "r"((int)direct));
        if constexpr (kTex) asm volatile("" ::"f"(t_u[k]), "f"(t_v[k]));
      }
    }
"""
WALK_ADD = (
    """__device__ __forceinline__ void add_nonzero(float* a, float v) {
  if (v != 0.0f) atomicAdd(a, v);
}""",
    """__device__ __forceinline__ void add_nonzero(float* a, float v) {
  asm volatile("" ::"f"(v), "l"(a));  // timing copy: no add
}""")

# ---- the shared tape's variants ---------------------------------------------

SHARED = [
    ("constexpr int kGradThreads = kThreads;  // a gradient block's threads\n",
     """constexpr int kGradThreads = kThreads;  // a gradient block's threads
template <bool kTex>
struct Tape {  // timing copy: the tape in shared memory
  static constexpr int kWords = kTex ? 7 : 5;
  float* t;
  __device__ __forceinline__ explicit Tape(float* s_tape)
      : t(s_tape + threadIdx.x) {}
  __device__ __forceinline__ float& at(int k, int w) const {
    return t[(k * kWords + w) * kGradThreads];
  }
};
"""),
    ("  float* s_tex = s_g + (kGrad ? p.n_obj * kGradCols : 0);\n",
     """  float* s_tex = s_g + (kGrad ? p.n_obj * kGradCols : 0);
  float* s_tape = s_tex + (kTex ? p.n_obj * kTexRow : 0);
"""),
    ("""    int t_id[kMaxTape];
    float t_cos[kMaxTape], t_m[3 * kMaxTape], t_c[3 * kMaxTape];
    float t_u[kMaxTape], t_v[kMaxTape];  // kTex: the color fetch's (u, v)
    int nb = 0;
    uint32_t upd_bits = 0u;
""", """    const Tape<kTex> tape(s_tape);
    int nb = 0;
"""),
    ("""          t_id[nb] = on_tri ? -1 - tri : w;
          t_cos[nb] = cosw;
          t_m[3 * nb] = mask_r;
          t_m[3 * nb + 1] = mask_g;
          t_m[3 * nb + 2] = mask_b;
          t_c[3 * nb] = own_col ? tcr : wm[24];
          t_c[3 * nb + 1] = own_col ? tcg : wm[25];
          t_c[3 * nb + 2] = own_col ? tcb : wm[26];
          if constexpr (kTex) {
            t_u[nb] = tex_u;
            t_v[nb] = tex_v;
          }
          if (!is_light) upd_bits |= 1u << nb;
""", """          tape.at(nb, 0) =
              __int_as_float((on_tri ? -1 - tri : w) * 2 + !is_light);
          tape.at(nb, 1) = cosw;
          tape.at(nb, 2) = mask_r;
          tape.at(nb, 3) = mask_g;
          tape.at(nb, 4) = mask_b;
          if constexpr (kTex) {
            tape.at(nb, 5) = tex_u;
            tape.at(nb, 6) = tex_v;
          }
"""),
    ("""          const int id = t_id[k];
          const bool upd = (upd_bits >> k) & 1u;
          const float cosb = t_cos[k];
          const float mr = t_m[3 * k], mg = t_m[3 * k + 1],
                      mb = t_m[3 * k + 2];
""", """          const int word = __float_as_int(tape.at(k, 0));
          const int id = word >> 1;
          const bool upd = word & 1;
          const float cosb = tape.at(k, 1);
          const float mr = tape.at(k, 2), mg = tape.at(k, 3),
                      mb = tape.at(k, 4);
"""),
    ("""                scatter_texels(p.gtex, p.n_texels, tt, t_u[k], t_v[k], gr,
                               gg, gb);""",
     """                scatter_texels(p.gtex, p.n_texels, tt, tape.at(k, 5),
                               tape.at(k, 6), gr, gg, gb);"""),
    ("""            const float sc_r = upd ? t_c[3 * k] * cosb : 1.0f;
            const float sc_g = upd ? t_c[3 * k + 1] * cosb : 1.0f;
            const float sc_b = upd ? t_c[3 * k + 2] * cosb : 1.0f;
""", """            float sc_r = 1.0f, sc_g = 1.0f, sc_b = 1.0f;
            if (upd) {  // the color, read again where the forward read it
              float cr, cg, cb;
              if (id < 0) {
                const float4 s2 =
                    __ldg(p.shade + (size_t)(-1 - id) * kTriVecs + 2);
                cr = s2.y;
                cg = s2.z;
                cb = s2.w;
              } else {
                const float* c = s_obj + id * kObjCols + 24;
                cr = c[0];
                cg = c[1];
                cb = c[2];
                if constexpr (kTex) {
                  const float* tt = s_tex + id * kTexRow;
                  if (tt[0] > 0.5f)
                    fetch_texture<kF32>(p, tt + 1, tt[kTexRecip],
                                        tt[kTexRecip + 1], tape.at(k, 5),
                                        tape.at(k, 6), cr, cg, cb);
                }
              }
              sc_r = cr * cosb;
              sc_g = cg * cosb;
              sc_b = cb * cosb;
            }
"""),
    ("""                                          (kTex ? kTexRow : 0)) +
                               kCamCols);
  const int threads""", """                                          (kTex ? kTexRow : 0)) +
                               kCamCols +
                               (kGrad ? (size_t)p.max_bounces *
                                            Tape<kTex>::kWords * kGradThreads
                                      : 0));
  const int threads"""),
]
# slim: shared's entries in local memory, no shared memory for them
SLIM = [
    ("""  float* t;
  __device__ __forceinline__ explicit Tape(float* s_tape)
      : t(s_tape + threadIdx.x) {}
  __device__ __forceinline__ float& at(int k, int w) const {
    return t[(k * kWords + w) * kGradThreads];
  }""",
     """  float t[kMaxTape * kWords];  // timing copy: local memory
  __device__ __forceinline__ explicit Tape(float*) {}
  __device__ __forceinline__ float& at(int k, int w) {
    return t[k * kWords + w];
  }"""),
    ("    const Tape<kTex> tape(s_tape);", "    Tape<kTex> tape(s_tape);"),
    ("""                               (kGrad ? (size_t)p.max_bounces *""",
     """                               (kGrad ? 0 * (size_t)p.max_bounces *"""),
]
NO_MERGE = ("  const unsigned peers = __match_any_sync(lanes, key);\n",
            "  return rank == 0;\n}\n")
NO_MERGE_NEW = "  return true;  // timing copy: each lane adds its own\n}\n"
SCALAR_ROW = (
    """  if (r != 0.0f || g != 0.0f || b != 0.0f)
    atomicAdd(reinterpret_cast<float4*>(row), make_float4(r, g, b, 0.0f));""",
    """  add_nonzero(row, r);  // timing copy: three scalar atomics
  add_nonzero(row + 1, g);
  add_nonzero(row + 2, b);""")
BLOCKS = "constexpr int kGradBlocks = 8;"
UNCAPPED = ("__global__ void __launch_bounds__(kGradThreads, kGradBlocks)",
            "__global__ void __launch_bounds__(kGradThreads)")
THREADS = "constexpr int kGradThreads = kThreads;"
PY_BLOCK = "_BLOCK = 128        # kGradThreads of csrc/megakernel.cu"


def _between(text: str, start: str, end: str, new: str,
             with_end: bool = False) -> str:
    """`text` with the span from `start` up to `end` after it (not
    including it, unless `with_end`) replaced by `new`; each marker must be
    there once."""
    for m in (start, end):
        if text.count(m) != 1:
            raise SystemExit(f"the marker {m[:40]!r} is there {text.count(m)} "
                             "times, not once")
    i = text.index(start)
    j = text.index(end)
    if j < i:
        raise SystemExit(f"the marker {end[:40]!r} comes before {start[:40]!r}")
    return text[:i] + new + text[j + (len(end) if with_end else 0):]


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"the text {old[:60]!r} is there {text.count(old)} "
                         "times, not once")
    return text.replace(old, new)


def edits(variant: str):
    """{file under the package: function of its text} of a variant."""
    if variant == "replay":
        return {CU: lambda t: _between(_between(t, *TAPE_WRITE, ""),
                                       *BACKWARD, REPLAY_BACKWARD)}
    if variant == "tape":
        return {CU: lambda t: _between(t, *BACKWARD, TAPE_BACKWARD)}
    if variant == "walk":
        return {CU: lambda t: _replace(t, *WALK_ADD)}
    if variant in ("shared", "slim"):
        def tape(t):
            for old, new in SHARED + (SLIM if variant == "slim" else []):
                t = _replace(t, old, new)
            return t
        return {CU: tape}
    if variant == "unmerged":
        return {CU: lambda t: _replace(_between(t, *NO_MERGE, NO_MERGE_NEW,
                                                True), *SCALAR_ROW)}
    if variant == "vector":
        return {CU: lambda t: _between(t, *NO_MERGE, NO_MERGE_NEW, True)}
    m = re.fullmatch(r"blocks(\d+)", variant)
    if m and 1 <= int(m.group(1)) <= 16:
        return {CU: lambda t: _replace(
            t, BLOCKS, f"constexpr int kGradBlocks = {m.group(1)};")}
    if variant == "uncapped":
        return {CU: lambda t: _replace(t, *UNCAPPED)}
    m = re.fullmatch(r"threads(64|256)", variant)
    if m:
        n = int(m.group(1))
        return {CU: lambda t: _replace(_replace(
                    t, THREADS, f"constexpr int kGradThreads = {n};"),
                    BLOCKS, f"constexpr int kGradBlocks = {8 * 128 // n};"),
                "render/grad.py": lambda t: _replace(
                    t, PY_BLOCK, PY_BLOCK.replace("128", str(n)))}
    raise SystemExit(__doc__)


def make(variant: str, src: str, dst: str) -> Path:
    """Copy SRC's package under DST and apply the variant's edits."""
    todo = edits(variant)
    out = Path(dst) / PKG
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(Path(src) / PKG, out,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, fn in todo.items():
        path = out / rel
        path.write_text(fn(path.read_text()))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        raise SystemExit(__doc__)
    print(make(*argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
