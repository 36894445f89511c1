"""The leaf microbenchmark (P3): the cost of one leaf visit alone, on the
card (csrc/megakernel.cu `leaf_bench`; the counterpart of the JAX package's
tools/leaf_microbench.py).

Rays aimed into `teapot`'s mesh (its object space) visit the mesh's leaves
back to back, warp by warp (visit v of warp w tests leaf (v + w) %
n_leaves), with no walk, through the leaf body of one variant. Each variant
runs at `visits` and 5 x `visits` leaf visits, and the marginal time per
visit (which cancels the launch's fixed cost) gives ns a visit of the whole
batch and G triangle tests a second. Variants (csrc/megakernel.cu
BENCH_*): `prod` (the production body, leaf_simt; the JAX harness's
`nonormal` is this one), `mma` (the tensor-core body, leaf_mma), `base`,
`hitpoint`, `tree` (the JAX harness's `treec` is this one) and `synth`.

    python -m pathtracer_tpu_torch.probes.leaf_bench [variant ...]
    python -m pathtracer_tpu_torch.probes.leaf_bench --device cpu

`check` holds `prod` and `mma` against their plain versions (the same
winners and t; `pairs` holds every ray x triangle t of the tensor-core
test). On the CPU (`--device cpu`) the plain versions run at a small size,
and their times are the CPU's.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..config import RenderConfig
from ..render import megakernel as mk
from ..scenes import get_scene
from .op_rate import best_seconds

VARIANTS = ("prod", "mma", "base", "hitpoint", "tree", "synth")
_PAIRS = 6          # pt_leaf_bench_launch's code for mma_pairs
RAYS = 1 << 18      # rays a launch on the card
VISITS = 100        # leaf visits of the short run (the long run: 5x)
_WARP = 32


LEAF = 32           # the leaf size timed: tools/leaf_microbench.py's


def teapot_leaves(device):
    """`teapot`'s triangle tables on `device`, packed at LEAF slots a leaf
    (build_mesh_tables for MXU leaves: the test records with the MXU
    fragments after them, and the shading records), its meta and its
    arrays."""
    cfg = RenderConfig(width=16, height=12, samples=1, samples_per_pass=1)
    arrays, meta = get_scene("teapot", cfg).pack(device=device,
                                                 leaf_size=LEAF)
    _, tris, shade = mk.build_mesh_tables(arrays, meta, traversal="mxu")
    return ((torch.from_numpy(tris).to(device),
             torch.from_numpy(shade).to(device)), meta, arrays)


def mesh_rays(arrays, n: int, device, seed: int = 0):
    """n rays aimed into the mesh's box from around it, the last quarter
    aimed away (tests/test_torch_mesh_walk.py's rays): ([ox, oy, oz, dx,
    dy, dz] f32 [n] each on `device`)."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(arrays.node_bb_min.cpu()).min(axis=0)
    hi = np.asarray(arrays.node_bb_max.cpu()).max(axis=0)
    center = (lo + hi) / 2
    o = center + rng.normal(size=(n, 3)) * (hi - lo).max() * 1.5
    tgt = lo + rng.random((n, 3)) * (hi - lo)
    miss = np.arange(n) >= (3 * n) // 4
    d = np.where(miss[:, None], o - center, tgt - o)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
            .to(device) for a in (*o.T, *d.T)]


def run(variant: str, rays, tables, meta, visits: int, eps: float = 1e-4,
        t_max: float = 1e30):
    """One launch of `variant` (or _PAIRS) on the rays over the triangle
    tables (teapot_leaves): (t f32 [n], idx i32 [n]) as
    pt_leaf_bench_launch writes them ([n, K] t for _PAIRS). CUDA tensors
    only; counted in run.launches."""
    tris, shade = tables
    mk._check_aligned(tri_table=tris, shade_table=shade)
    n = rays[0].numel()
    K = meta.leaf_size
    code = _PAIRS if variant == "pairs" else VARIANTS.index(variant)
    lib = mk.library()
    out = torch.empty(n * (K if code == _PAIRS else 1), dtype=torch.float32,
                      device=rays[0].device)
    idx = torch.empty(n, dtype=torch.int32, device=rays[0].device)
    mxu = mk.mxu_ptr(tris, meta, mk.Walk("block", "mma"))
    with torch.cuda.device(rays[0].device):
        err = lib.pt_leaf_bench_launch(
            *(r.data_ptr() for r in rays), out.data_ptr(), idx.data_ptr(), n,
            visits, tris.data_ptr(), shade.data_ptr(), mxu, K,
            meta.n_tri_slots // K, eps,
            t_max, code, torch.cuda.current_stream(rays[0].device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"leaf bench launch failed: CUDA error {err}")
    run.launches += 1
    return out, idx


run.launches = 0


def plain(variant: str, rays, tables, meta, visits: int, eps: float = 1e-4,
          t_max: float = 1e30):
    """The plain version of `prod` or `mma` (the leaf tests of
    megakernel.leaf_tests or leaf_tests_mma, merged in visit order), or
    of `pairs` (every ray x triangle t of the tensor-core test, _BIG where
    the pair does not hit): the outputs of `run`."""
    n = rays[0].numel()
    K = meta.leaf_size
    n_leaves = meta.n_tri_slots // K
    warp = torch.arange(n, device=rays[0].device) // _WARP
    tris = tables[0]
    frag = mk.mxu_view(tris, meta)
    if variant == "pairs":
        start = (warp % n_leaves) * K
        return mk.leaf_tests_mma(frag, start, K, eps, *rays,
                                  pairs=True).reshape(-1), None
    bt = torch.full((n,), mk._BIG, device=rays[0].device)
    slot = torch.full((n,), -1, dtype=torch.int64, device=rays[0].device)
    for v in range(visits):
        start = ((v + warp) % n_leaves) * K
        if variant == "mma":
            tw, s, _, _ = mk.leaf_tests_mma(frag, start, K, eps, *rays)
        elif variant == "prod":
            tw, s, _, _ = mk.leaf_tests(tris, start, K, eps, *rays)
        else:
            raise ValueError(f"no plain version of {variant!r}")
        won = (tw < bt) & (tw < t_max)
        bt = torch.where(won, tw, bt)
        slot = torch.where(won, s, slot)
    return bt, slot.to(torch.int32)


def check(rays, tables, meta, visits: int = 3) -> dict:
    """`prod` and `mma` against their plain versions on the rays (CUDA):
    `prod` bit for bit; `mma`'s t within one ulp on every ray and its
    winner equal except where another slot has the same t; `pairs` every
    ray x triangle t within one ulp. Returns the counts."""
    out = {}
    for v in ("prod", "mma"):
        kt, ks = run(v, rays, tables, meta, visits)
        pt, ps = plain(v, rays, tables, meta, visits)
        ulp = _ulps(kt, pt)
        same = ks.long() == ps.long()
        out[v] = {"rays": kt.numel(), "bit_equal_t": int((kt == pt).sum()),
                  "t_within_1ulp": int((ulp <= 1).sum()),
                  "winner_equal": int(same.sum()),
                  "winner_differs_at_tie": int((~same & (kt == pt)).sum())}
    kt, _ = run("pairs", rays, tables, meta, 1)
    pt, _ = plain("pairs", rays, tables, meta, 1)
    hit = (kt < mk._BIG) | (pt < mk._BIG)
    ulp = _ulps(kt, pt)
    out["pairs"] = {"pairs": kt.numel(), "hit_pairs": int(hit.sum()),
                    "bit_equal": int((kt == pt).sum()),
                    "within_1ulp": int((ulp <= 1).sum()),
                    "hit_within_1ulp": int(((ulp <= 1) & hit).sum())}
    return out


def _ulps(a, b):
    """|a - b| in f32 ulps (positive finite values; kBig pairs compare as
    any other)."""
    ai = a.contiguous().view(torch.int32).long()
    bi = b.contiguous().view(torch.int32).long()
    return (ai - bi).abs()


def measure(variant: str, rays, tables, meta, visits: int = VISITS) -> dict:
    """The marginal cost of a leaf visit of `variant`: the launch at
    `visits` and at 5 x `visits`. Returns {"ns_per_visit" (the batch's
    rays, one leaf each), "gtests_per_s", "ms", "ms_5x", "rays", "visits",
    "leaf"}; on CPU tensors the plain version's."""
    dev = rays[0].device
    if dev.type == "cuda":
        def fn(v):
            return run(variant, rays, tables, meta, v)
    else:
        def fn(v):
            return plain(variant, rays, tables, meta, v)
    fn(visits)  # build, and warm up
    t1 = best_seconds(lambda: fn(visits), dev)
    t5 = best_seconds(lambda: fn(5 * visits), dev)
    per = max(t5 - t1, 1e-12) / (4 * visits)
    n, K = rays[0].numel(), meta.leaf_size
    return {"ns_per_visit": per * 1e9, "gtests_per_s": n * K / per / 1e9,
            "ms": t1 * 1e3, "ms_5x": t5 * 1e3, "rays": n, "visits": visits,
            "leaf": K}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; default) or cpu (the plain "
                         "versions of prod and mma, at a small size)")
    ap.add_argument("--rays", type=int, default=None)
    ap.add_argument("--visits", type=int, default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device (run the plain versions with --device cpu)")
    cuda = dev.type == "cuda"
    variants = args.variants or (list(VARIANTS) if cuda else ["prod", "mma"])
    tables, meta, arrays = teapot_leaves(dev)
    rays = mesh_rays(arrays, args.rays or (RAYS if cuda else 1024), dev)
    if cuda:
        print(json.dumps({"check": check(rays, tables, meta)}), flush=True)
    for v in variants:
        r = measure(v, rays, tables, meta, args.visits or (VISITS if cuda
                                                         else 2))
        print(json.dumps({"variant": v, "device": str(dev), **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
