#!/usr/bin/env python3
"""Make the timing copies of pathtracer_tpu_torch that chip_smoke.py times
the packet walks (Kernel A, the warp-packet walk, and Kernel B, its
tensor-core leaves) against (`--walk-split DIR`, `--ab-parent DIR`).

    python3 tools/walk_variants.py VARIANT[+VARIANT...] SRC DST

SRC and DST are directories holding a pathtracer_tpu_torch package (a
checkout, or `git archive <commit> pathtracer_tpu_torch` unpacked under the
git-ignored build/); DST/pathtracer_tpu_torch is replaced by a copy of
SRC's with the variants' edits, applied in the order given (SRC = DST
edits a tree in place). Each edit must find its text exactly once, or the
script fails.

The split of the packet walks, on the tree before their redesign (commit
29588ef, the base below). The copies marked "timing only" change the bits:

- novote (timing only): WALK_BLOCK's octant vote counts the warp alone
  (four ballots, no barrier): what the vote's four block barriers cost.
- anywarp (timing only; after novote, e.g. `novote+anywarp`): the
  bounce's group_any a warp vote, so that no block barrier is left.
- onetile (timing only): the tensor-core leaf computes its first 8-ray
  column tile alone.
- noreduce (timing only): the tensor-core leaf hands each lane's own
  column-pair winner to the ray without the reduction over the lanes.
- simtdots (timing only): the tensor-core leaf's plane dots by f32 FMA on
  the SIMT cores (each lane its triangle row against its two rays, read
  from shared memory) instead of the FP64 DMMA.
- the node walk alone is not a copy: PT_ABLATE_LEAF=1 selects it.

The candidates of the redesign, each a patch (tools/walk_variants/NAME.patch)
whose context must match the tree it is applied to exactly once:

- a1 (on the base): WALK_BLOCK's octant vote in one barrier (a ballot of each
  count per warp, the warps' counts in one of two shared slots used in
  turn). Not shipped.
- a2 (on a1, or alone on the base: Step 0's "dead warps skipped"): under
  WALK_BLOCK a warp whose paths have all ended leaves the bounce and only
  casts its false votes (idle_votes). Not shipped.
- a3 (on the base, or on a1+a2): the packet walk's leaf records loaded once a
  warp, one float4 a lane, and handed to the lanes by shuffles (leaf_warp)
  instead of each lane's 3K uniform loads. Not shipped.
- a4 (on the base): the packet walks' SIMT-leaf and leaf-less
  kernels bounded to 8 blocks an SM (packet_megakernel, kPacketBlocks);
  pblocksN (after a4) sets N blocks instead (a4+pblocks6 is the first a4 measured).
  Not shipped (mode 3 -2.93%, short of the rule).
- b1 (on the base; shipped): the tensor-core leaf skips the 8-ray column
  tiles in which no ray's slab hit the leaf.
- b2 (on b1): its (t, slot) reduction as one 64-bit key. Not shipped.
- b3a (on b1; shipped): the rays as the DMMA's A and the plane tiles as
  its B, and a leaf of K <= 4 packs two plane groups a tile (4 DMMAs an
  8-ray tile instead of 6; render/megakernel.py mxu_fragments' layout),
  the (t, slot) minimum over a ray's four lanes in two rounds.
- b3a-key (on b2): b3a with b2's key (the first chain measured).
- b3b (on b3a-key): sm_90's m16n8k4 FP64 product, two 8-ray tiles a
  product. Not shipped.
- b4 (on b3a; shipped): the ray fragments read from shared memory where a
  product takes them, not kept in registers across the walk.
- b4-b3b (on b3b): b4 on the first chain measured.

The shipped kernel is `b1+b3a+b4` on the base. The A/B runs measured, in
turn: the chain a1, a2, b1, b2, b3a-key, b3b, b4-b3b (and a3 on a2); then
a4+pblocks6, a2 and a3 alone on the base, and b1, b3a, b4 in turn; then a4
and b1, b3a, b4 again (their numbers: PERF.md §6).
"""
from __future__ import annotations

import re
import shutil
import sys
from pathlib import Path

PKG = "pathtracer_tpu_torch"
CU = "csrc/megakernel.cu"
PATCHES = Path(__file__).resolve().parent / "walk_variants"
ORDER = ("a1", "a2", "a3", "a4", "b1", "b2", "b3a", "b3a-key", "b3b", "b4",
         "b4-b3b")

# ---- Step 0: the split of the base tree's packet walks --------------------

NOVOTE = [
    ("  if constexpr (kWalk == WALK_BLOCK) {\n"
     "    n = __syncthreads_count(act);\n",
     "  if constexpr (false) {\n"
     "    n = __syncthreads_count(act);\n"),
]

ANYWARP = [
    ("  if constexpr (kWalk == WALK_BLOCK) return __syncthreads_or(v);\n",
     ""),
]

ONETILE = [
    ("  int mk = 0;\n  for (int ct = 0; ct < 4; ++ct) {\n",
     "  int mk = 0;\n  for (int ct = 0; ct < 1; ++ct) {\n"),
]

NOREDUCE = [
    ("""    // (t, k)-lexicographic minimum over the 8 lanes of a column pair
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float ot = __shfl_xor_sync(kFull, bt2[i], off);
        const int ok = __shfl_xor_sync(kFull, bk[i], off);
        const float ou = __shfl_xor_sync(kFull, bu[i], off);
        const float ov = __shfl_xor_sync(kFull, bv[i], off);
        if (ot < bt2[i] || (ot == bt2[i] && ok < bk[i])) {
          bt2[i] = ot;
          bk[i] = ok;
          bu[i] = ou;
          bv[i] = ov;
        }
      }
    }
""", ""),
]

SIMTDOTS = [
    ("""    q.d[ct] = c == 0 ? u : c == 1 ? v : c == 2 ? w : 0.0f;
  }
  return q;
}
""", """    q.d[ct] = c == 0 ? u : c == 1 ? v : c == 2 ? w : 0.0f;
  }
  float4* r = reinterpret_cast<float4*>(s_simt_rays[threadIdx.x >> 5][lane]);
  __syncwarp();
  r[0] = make_float4(ox, oy, oz, 1.0f);
  r[1] = make_float4(dx, dy, dz, 0.0f);
  __syncwarp();
  return q;
}
"""),
    ("""struct RayFrags {
  double o[4], d[4];
};
""", """struct RayFrags {
  double o[4], d[4];
};

// simtdots: each lane's ray, [o, 1, d, 0], for the SIMT plane dots
__shared__ __align__(16) float s_simt_rays[kThreads / 32][32][8];
"""),
    ("""#pragma unroll
  for (int g = 0; g < 6; ++g)
    dmma(d[g][0], d[g][1], (double)__ldg(a + (g * nkt + kt) * 32),
         d_half(g) ? q.d[ct] : q.o[ct]);
}
""", """  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < 6; ++g) {
    const float4 c = __ldg(reinterpret_cast<const float4*>(
        a - lane + (g * nkt + kt) * 32 + 4 * (lane >> 2)));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 x = reinterpret_cast<const float4*>(
          s_simt_rays[threadIdx.x >> 5][ct * 8 + 2 * (lane & 3) + i])
          [d_half(g) ? 1 : 0];
      d[g][i] = (double)fmaf(c.x, x.x,
                             fmaf(c.y, x.y, fmaf(c.z, x.z, c.w * x.w)));
    }
  }
}
"""),
]

EDITS = {"novote": NOVOTE, "anywarp": ANYWARP, "onetile": ONETILE,
         "noreduce": NOREDUCE, "simtdots": SIMTDOTS}
# pblocksN (after a4): the packet kernels' bound asks for N blocks an SM, not 8
EDITS.update({f"pblocks{n}": [("constexpr int kPacketBlocks = 8;\n",
                               f"constexpr int kPacketBlocks = {n};\n")]
              for n in range(1, 17)})


def patch_edits(name: str):
    """The edits of tools/walk_variants/NAME.patch: [(file, old, new)], one
    per hunk (its context and removed lines -> its context and added
    lines)."""
    out, path = [], None
    old = new = None
    for line in (PATCHES / f"{name}.patch").read_text().splitlines(True):
        if line.startswith(("--- ", "+++ ", "@@")) and old is not None:
            out.append((path, "".join(old), "".join(new)))
            old = new = None
        if line.startswith("--- "):
            continue
        if line.startswith("+++ "):
            path = line[4:].strip()
            continue
        if line.startswith("@@"):
            old, new = [], []
            continue
        if line.startswith("\\"):
            continue
        tag, text = line[:1], line[1:]
        if tag in (" ", "-"):
            old.append(text)
        if tag in (" ", "+"):
            new.append(text)
    if old is not None:
        out.append((path, "".join(old), "".join(new)))
    return out


def edits_of(variant: str):
    """[(file under the package, old, new)] of one variant."""
    if variant in EDITS:
        return [(CU, old, new) for old, new in EDITS[variant]]
    if (PATCHES / f"{variant}.patch").exists():
        return [(re.sub(rf"^{PKG}/", "", f), old, new)
                for f, old, new in patch_edits(variant)]
    raise SystemExit(f"unknown variant {variant!r}: one of "
                     f"{sorted(EDITS) + list(ORDER)}")


def apply(text: str, edits, what: str) -> str:
    for old, new in edits:
        n = text.count(old)
        if n != 1:
            raise SystemExit(f"{what}: an edit's text is found {n} times, "
                             f"not once: {old[:120]!r}")
        text = text.replace(old, new)
    return text


def main(argv) -> int:
    if len(argv) != 3:
        print(__doc__)
        return 2
    variants, src, dst = argv[0].split("+"), Path(argv[1]), Path(argv[2])
    texts = {}
    for variant in variants:
        for f, old, new in edits_of(variant):
            if f not in texts:
                texts[f] = (src / PKG / f).read_text()
            texts[f] = apply(texts[f], [(old, new)], f"{variant} ({f})")
    if src.resolve() != dst.resolve():
        if (dst / PKG).exists():
            shutil.rmtree(dst / PKG)
        shutil.copytree(src / PKG, dst / PKG, ignore=shutil.ignore_patterns(
            "__pycache__", "build"))
    for f, text in texts.items():
        (dst / PKG / f).write_text(text)
    print(f"{'+'.join(variants)}: {dst / PKG}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
