#!/usr/bin/env python3
"""Make the variant copies of pathtracer_tpu_torch that chip_smoke.py times
K1-tex's fetch against (`--tex-split DIR`, `--ab-parent DIR`).

    python3 tools/tex_variants.py VARIANT SRC DST

VARIANT is one of pinned, quad, pinned-quad, looped, capped.

SRC and DST are directories holding a pathtracer_tpu_torch package (a
checkout, or `git archive <commit> pathtracer_tpu_torch` unpacked under
the git-ignored build/); DST/pathtracer_tpu_torch is replaced by a copy of
SRC's with one edit:

- pinned: for a tree whose fetch takes four taps from the rgb8 pool (the
  kernels before the quad rows), the four loads of sample_pool read the
  first tap's address. Each load is an `asm volatile` that also takes its
  own index as an input, so the index math and the four load instructions
  stay; the taps then always hit in L1, and the time the copy saves is
  what the loads cost (its renders differ from the tree's).
- quad: for this tree, the rgb8 fetch reads quad rows (row i: texel i and
  its REPEAT neighbours [c00, c01, c10, c11], built by texture_inputs for
  each texture the table names; 4x the pool's memory), one 16-byte load
  at the anchor where the fast wrap holds; bit-equal. The design the
  quad rows' A/B measured and left out.
- pinned-quad: for a quad tree (quad's output), the row's load reads the
  texture's first row, the same way (the index math stays).
- looped: the bounce's normal-map and color fetches from one call site, a
  loop over the two kept rolled (#pragma unroll 1), for fewer registers;
  bit-equal.
- capped: the textured forward instantiations on an entry of their own
  with __launch_bounds__(128, 8) (at most 64 registers), bit-equal.

Each edit must find its text exactly once, or the script fails.
"""
from __future__ import annotations

import shutil
import sys
from pathlib import Path

PKG = "pathtracer_tpu_torch"

PINNED_CU = [(
    """  float c00[3], c01[3], c10[3], c11[3];
  decode_rgb8(__ldg(pool + min(max(bi + r0 * wi + c0, bi), last)), c00[0],
              c00[1], c00[2]);
  decode_rgb8(__ldg(pool + min(max(bi + r0 * wi + c1, bi), last)), c01[0],
              c01[1], c01[2]);
  decode_rgb8(__ldg(pool + min(max(bi + r1 * wi + c0, bi), last)), c10[0],
              c10[1], c10[2]);
  decode_rgb8(__ldg(pool + min(max(bi + r1 * wi + c1, bi), last)), c11[0],
              c11[1], c11[2]);""",
    """  float c00[3], c01[3], c10[3], c11[3];
  const int* at = pool + min(max(bi + r0 * wi + c0, bi), last);
  const auto pinned = [at](int keep) {
    int q;
    asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(q) : "l"(at), "r"(keep));
    return q;
  };
  decode_rgb8(pinned(min(max(bi + r0 * wi + c0, bi), last)), c00[0],
              c00[1], c00[2]);
  decode_rgb8(pinned(min(max(bi + r0 * wi + c1, bi), last)), c01[0],
              c01[1], c01[2]);
  decode_rgb8(pinned(min(max(bi + r1 * wi + c0, bi), last)), c10[0],
              c10[1], c10[2]);
  decode_rgb8(pinned(min(max(bi + r1 * wi + c1, bi), last)), c11[0],
              c11[1], c11[2]);""")]

QUAD_CU = [(
    """  int4 q;
  if (kFast && wrap_is_fast(x0, y0, w, h)) {
    const float c0 = wrap_fast(x0, w, iw), r0 = wrap_fast(y0, h, ih);
    const float c1 = c0 + 1.0f == w ? 0.0f : c0 + 1.0f;
    const float r1 = r0 + 1.0f == h ? 0.0f : r0 + 1.0f;
    const float row0 = base + r0 * w, row1 = base + r1 * w;
    q = make_int4(__ldg(pool + (int)(row0 + c0)),
                  __ldg(pool + (int)(row0 + c1)),
                  __ldg(pool + (int)(row1 + c0)),
                  __ldg(pool + (int)(row1 + c1)));
  } else {
    q = taps_take4(pool, base, w, h, x0, y0);
  }
  blend_rgb8(q, tx, ty, r, g, b);""",
    """  // pool holds quad rows [T, 4]: row i is texel i and its REPEAT
  // neighbours [c00, c01, c10, c11]; one 16-byte load at the anchor where
  // the fast wrap holds, the four taps from column 0 elsewhere
  if (kFast && wrap_is_fast(x0, y0, w, h)) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(pool) +
                         (int)(base + wrap_fast(y0, h, ih) * w +
                               wrap_fast(x0, w, iw)));
    blend_rgb8(q, tx, ty, r, g, b);
  } else {
    const int bi = (int)base, wi = (int)w;
    const int last = bi + wi * (int)h - 1;
    const int c0 = (int)wrap_tex(x0, w), c1 = (int)wrap_tex(x0 + 1.0f, w);
    const int r0 = (int)wrap_tex(y0, h), r1 = (int)wrap_tex(y0 + 1.0f, h);
    const auto tap = [&](int y, int x) {
      return __ldg(pool + 4 * min(max(bi + y * wi + x, bi), last));
    };
    blend_rgb8(make_int4(tap(r0, c0), tap(r0, c1), tap(r1, c0), tap(r1, c1)),
               tx, ty, r, g, b);
  }""")]

QUAD_PY = [
    ("""    return {"tex_pool": scn.tex_pool_u32.view(torch.int32).to(device)
            .contiguous(),
            "tex_table": torch.from_numpy(build_tex_table(scn, meta))
            .to(device)}""",
     """    pool = scn.tex_pool_u32.view(torch.int32).cpu().numpy()
    quad = np.repeat(pool[:, None], 4, axis=1)
    table = build_tex_table(scn, meta)
    for col in (0, 6):
        for base, w, h in {tuple(int(x) for x in row[col + 1:col + 4])
                           for row in table if row[col] > 0.5}:
            p = pool[base:base + w * h].reshape(h, w)
            c10 = np.roll(p, -1, axis=0)
            quad[base:base + w * h] = np.stack(
                [p, np.roll(p, -1, axis=1), c10, np.roll(c10, -1, axis=1)],
                axis=-1).reshape(-1, 4)
    return {"tex_pool": torch.from_numpy(quad).to(device),
            "tex_table": torch.from_numpy(table).to(device)}"""),
    ("""            want += (("tex_pool", tex_pool, torch.int32,
                      (tex_pool.numel(),)),)""",
     """            want += (("tex_pool", tex_pool, torch.int32,
                      (tex_pool.shape[0], 4)),)"""),
    ("""            return sample_pool(tex_pool, *a)""",
     """            return sample_pool(tex_pool[:, 0], *a)"""),
]

PINNED_QUAD_CU = [(
    """    const int4 q = __ldg(reinterpret_cast<const int4*>(pool) +
                         (int)(base + wrap_fast(y0, h, ih) * w +
                               wrap_fast(x0, w, iw)));""",
    """    const int keep = (int)(base + wrap_fast(y0, h, ih) * w +
                           wrap_fast(x0, w, iw));
    int4 q;
    asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(q.x), "=r"(q.y), "=r"(q.z), "=r"(q.w)
                 : "l"(reinterpret_cast<const int4*>(pool) + (int)base),
                   "r"(keep));""")]

LOOPED_CU = [(
    """        const float* tt = s_tex + w * kTexRow;
        if (!on_tri && tt[6] > 0.5f) {
          fetch_texture<kF32>(p, tt + 7, tt[kTexRecip + 2],
                              tt[kTexRecip + 3], fabsf(lx) * tt[10],
                              fabsf(lz) * tt[11], nlx, nly, nlz);
        }
        if (!on_tri && tt[0] > 0.5f) {
          float su, sv;
          if (w_type == PLANE) {""",
    """        const float* tt = s_tex + w * kTexRow;
#pragma unroll 1
        for (int c = 6; c >= 0; c -= 6) {
          if (on_tri || !(tt[c] > 0.5f)) continue;
          float su, sv;
          if (c == 6) {
            su = fabsf(lx) * tt[10];
            sv = fabsf(lz) * tt[11];
          } else if (w_type == PLANE) {"""), (
    """          fetch_texture<kF32>(p, tt + 1, tt[kTexRecip], tt[kTexRecip + 1],
                              su, sv, tcr, tcg, tcb);
          own_col = true;
          if constexpr (kGrad) {
            tex_u = su;
            tex_v = sv;
          }
        }""",
    """          float fr, fg, fb;
          fetch_texture<kF32>(p, tt + c + 1, tt[kTexRecip + c / 3],
                              tt[kTexRecip + c / 3 + 1], su, sv, fr, fg, fb);
          if (c == 6) {
            nlx = fr;
            nly = fg;
            nlz = fb;
          } else {
            tcr = fr;
            tcg = fg;
            tcb = fb;
            own_col = true;
            if constexpr (kGrad) {
              tex_u = su;
              tex_v = sv;
            }
          }
        }""")]

CAPPED_CU = [
    ("""constexpr int kGradBlocks = 8;""",
     """constexpr int kGradBlocks = 8;
template <bool kMesh, bool kF32, bool kNee>
__global__ void __launch_bounds__(kThreads, 8) tex_megakernel(Params p) {
  megakernel_body<kMesh, false, true, kF32, kNee>(p);
}"""),
    ("""    } else {
      if (mesh)
        megakernel<true, false, kTex, kF32, kNee>
            <<<blocks, kThreads, smem, s>>>(p);
      else
        megakernel<false, false, kTex, kF32, kNee>
            <<<blocks, kThreads, smem, s>>>(p);
    }""",
     """    } else if constexpr (kTex) {
      if (mesh)
        tex_megakernel<true, kF32, kNee><<<blocks, kThreads, smem, s>>>(p);
      else
        tex_megakernel<false, kF32, kNee><<<blocks, kThreads, smem, s>>>(p);
    } else {
      if (mesh)
        megakernel<true, false, kTex, kF32, kNee>
            <<<blocks, kThreads, smem, s>>>(p);
      else
        megakernel<false, false, kTex, kF32, kNee>
            <<<blocks, kThreads, smem, s>>>(p);
    }""")]

EDITS = {
    "pinned": {"csrc/megakernel.cu": PINNED_CU},
    "quad": {"csrc/megakernel.cu": QUAD_CU,
             "render/megakernel.py": QUAD_PY},
    "pinned-quad": {"csrc/megakernel.cu": PINNED_QUAD_CU},
    "looped": {"csrc/megakernel.cu": LOOPED_CU},
    "capped": {"csrc/megakernel.cu": CAPPED_CU},
}


def make(variant: str, src: str, dst: str) -> Path:
    """Copy SRC's package under DST and apply the variant's edits."""
    out = Path(dst) / PKG
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(Path(src) / PKG, out,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, pairs in EDITS[variant].items():
        path = out / rel
        text = path.read_text()
        for old, new in pairs:
            if text.count(old) != 1:
                raise SystemExit(f"{variant}: {rel}: the text to replace is "
                                 f"there {text.count(old)} times, not once")
            text = text.replace(old, new)
        path.write_text(text)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3 or argv[0] not in EDITS:
        raise SystemExit(__doc__)
    print(make(*argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
