"""The reference's own BVH: a median split on the longest axis of the
centroids, emitted depth first with skip links, so that a ray walks it
with one node index (hit: the next node; miss: the node's exit).

Any BVH whose boxes hold their triangles gives the same nearest hit; this
one shares no code and no split rule with the program's builder. Leaves
hold up to `leaf_size` contiguous triangle slots, padded with degenerate
all-zero triangles, which no ray hits.
"""
from __future__ import annotations

import numpy as np

PAD = 1e-4    # boxes grow by this much, so that a flat leaf has extent


def build(p1, p2, p3, leaf_size: int):
    """(nodes [Nn, 8] f32: bbmin, leaf start or -1, bbmax, exit; slot ->
    triangle id [Ns] int64, -1 for padding)."""
    lo = np.minimum(np.minimum(p1, p2), p3)
    hi = np.maximum(np.maximum(p1, p2), p3)
    cen = (lo + hi) * 0.5
    rows, slots = [], []

    def emit(ids):
        me = len(rows)
        row = np.zeros(8)
        row[0:3] = lo[ids].min(axis=0) - PAD
        row[4:7] = hi[ids].max(axis=0) + PAD
        rows.append(row)
        if len(ids) <= leaf_size:
            row[3] = len(slots)
            slots.extend(ids.tolist() + [-1] * (leaf_size - len(ids)))
        else:
            row[3] = -1.0
            c = cen[ids]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            order = ids[np.argsort(c[:, axis], kind="stable")]
            half = len(order) // 2
            emit(order[:half])
            emit(order[half:])
        row[7] = len(rows)

    emit(np.arange(p1.shape[0]))
    return (np.stack(rows).astype(np.float32),
            np.asarray(slots, dtype=np.int64))
