"""The least time the card could take for a kernel's work, and the peaks
it is held to.

Frozen copy of `F32_OPS_PER_S`, `PEAK_BYTES`, the `OPS_*` counts,
`work_bound` (the forward kernel's object loop, hits and walk; no
textures, no shadow rays) and `bound_of` of chip_smoke.py at commit
7dc6265. Operations per unit of work were counted from
csrc/megakernel.cu: adds, subtracts, multiplies, divides, square roots,
min/max/abs/floor/trunc, cos/sin and int-to-float conversions one each;
the integer hash, comparisons and selects not. The units of work are what
the benchmark's reference counts (ptbench/ref/trace.py `counts`): the
samples, the rays alive at a bounce's intersection, the hits, the nodes
visited and the triangle slots tested.

The rate: NVIDIA's H100 SXM data sheet gives 67 TFLOP/s in float32
outside the tensor cores, counting a fused multiply-add as two. The
kernels build with -fmad=false, so each multiply and each add issues
alone: 16,896 lanes x 1.98 GHz = 33.45e12 operations a second. Bytes:
3.35 TB/s of HBM3. Both at the card's full power limit of 700 W.
"""
from __future__ import annotations

F32_OPS_PER_S = 16896 * 1.98e9
PEAK_BYTES = 3.35e12
PLANE, SPHERE, CYLINDER, BOX, GROUP = range(5)
OPS_SAMPLE = 44          # jittered camera ray, normalize, the sums' adds
OPS_OBJECT = {           # one object's transform and test, per live ray
    PLANE: 33 + 3, SPHERE: 33 + 29, CYLINDER: 33 + 26, BOX: 33 + 26,
    GROUP: 33 + 25,      # the group's box pretest; the walk counts apart
}
# the narrowed object loop: a plane transforms its y row alone before its
# test; the winner's full transform runs once a hit, after the loop
OPS_OBJECT_NARROW = {**OPS_OBJECT, PLANE: 11 + 3}
OPS_WINNER = 33
OPS_HIT = 125            # a diffuse hit: normal, roulette, bounce, resolve
OPS_NODE = 22            # one node's slab test
OPS_LEAF_SLOT = 34       # one triangle's test


def forward_ops(counts: dict, types) -> float:
    """f32 operations of the forward kernel's work in `counts` (samples,
    bounces, hits, node_visits, leaf_slots) on a scene of object `types`."""
    per_ray = sum(OPS_OBJECT_NARROW[t] for t in types)
    return (OPS_SAMPLE * counts["samples"]
            + counts["bounces"] * per_ray
            + (OPS_WINNER + OPS_HIT) * counts["hits"]
            + OPS_NODE * counts.get("node_visits", 0)
            + OPS_LEAF_SLOT * counts.get("leaf_slots", 0))


def bound_of(ops: float, n_bytes: float):
    """(bound in seconds, "operations" or "bytes") of `ops` f32 operations
    and `n_bytes` bytes moved."""
    t_ops = ops / F32_OPS_PER_S
    t_bytes = n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
