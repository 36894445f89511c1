"""The reference value of chosen pixels of a frame rendered through the
driver over a (pixels, spp) mesh of ranks: what `render_driver(mesh=)`
gives on every rank of a P x S mesh, each sample traced by
`trace.radiance`.

Frozen copy of the mesh's layout, schedule and sums in
pathtracer_tpu_torch at commit 5ad9167 (`megakernel_shards(...,
pack=False)` and `megakernel_shard` of parallel/render_dist.py, the chunk
schedule of driver.py's `_render_frame` under a mesh, `RenderMesh.total`
of parallel/mesh.py, the host finish), with the knobs at their defaults:

- the layout: `tile_pixel_layout(W, H, S, L, shard_granule=P, order)`
  with no sample packing, on the row axis: the one-card slot layout
  (`layout.pixel_layout`), its rows padded to a multiple of S * P; pixel
  shard p takes the p-th of P equal runs of rows, its tiles numbered from
  0 (the tile key) and its elements as on one card;
- the schedule: chunks of 8 spp, their count rounded up to a multiple of
  the spp axis; segments of 128 spp on a primitive scene, 8 on a mesh,
  in chunks rounded up to a multiple of the spp axis; in a segment of n
  chunks from chunk c0, spp rank s of pixel shard p renders (n / S) * 8
  samples under the seed frame_seed * 7919 + c0 * P * S + p * S + s + 1;
- the sums: a launch's samples of a slot in float32, a rank's segments in
  float32, the spp ranks' partials in float32 in rank order (two ranks
  add alike either way), then float64, over the samples rendered.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import hashrng, layout, trace
from .scene import RefScene

RAYS_A_BATCH = 1 << 22


def shard_layout(W: int, H: int, S: int, L: int, order: str, P: int
                 ) -> np.ndarray:
    """pid [rows * L]: the one-card layout without packing, its rows
    padded (pid -1) to a multiple of S * P."""
    pid = layout.pixel_layout(W, H, S, L, order)
    extra = (-(pid.size // L)) % (S * P)
    return np.concatenate([pid, np.full(extra * L, -1, pid.dtype)])


def segments(samples: int, has_mesh: bool, spp_axis: int,
             spp_chunk: int = 8):
    """([(first chunk c0, spp a rank renders in the segment)], the spp of
    the frame): the driver's segments under a mesh of `spp_axis` spp
    ranks."""
    spp_chunk = min(spp_chunk, samples)
    n_chunks = max(1, (samples + spp_chunk - 1) // spp_chunk)
    n_chunks = -(-n_chunks // spp_axis) * spp_axis
    seg_spp = 8 if has_mesh else 128
    seg_len = max(1, min(n_chunks, max(1, seg_spp // spp_chunk)))
    seg_len = -(-seg_len // spp_axis) * spp_axis
    out, c = [], 0
    while c < n_chunks:
        n = min(seg_len, n_chunks - c)
        out.append((c, (n // spp_axis) * spp_chunk))
        c += n
    return out, n_chunks * spp_chunk


class ShardSlots(NamedTuple):
    """Where each of a set of pixels lies on the mesh."""
    pix_rank: np.ndarray   # [P] the pixel shard of its slot
    tile: np.ndarray       # [P] tile index within the shard
    elem: np.ndarray       # [P] element index within the tile
    u_elem: np.ndarray     # [P] element index of the shared draws


def shard_slots(W: int, H: int, S: int, L: int, order: str, P: int,
                pixels: np.ndarray) -> ShardSlots:
    pid = shard_layout(W, H, S, L, order, P)
    order_ = np.argsort(pid, kind="stable")
    slot = order_[np.searchsorted(pid[order_], pixels)]
    if not np.all(pid[slot] == pixels):
        raise ValueError("pixels outside the layout")
    if int((pid == pixels[0]).sum()) != 1:
        raise ValueError("a pixel with sample replicas")
    rows_a_shard = pid.size // L // P
    row, lane = slot // L, slot % L
    local = row % rows_a_shard
    return ShardSlots(pix_rank=row // rows_a_shard, tile=local // S,
                      elem=(local % S) * L + lane, u_elem=(local % S) * L)


def frame_pixels(sc: RefScene, config: dict, samples: int, frame_seed: int,
                 pixels: np.ndarray, device, shape=(2, 2),
                 dtype=torch.float32) -> np.ndarray:
    """[n, 3] float32 values at flat pixel ids `pixels` (sorted) of the
    frame seeded `frame_seed` on a `shape` = (P, S) mesh. `dtype` is the
    precision of each path; the sums stay in the driver's."""
    W, H = config["width"], config["height"]
    P, Sx = (int(v) for v in shape)
    segs, total_spp = segments(samples, sc.has_mesh, Sx)
    N = segs[0][1]
    if any(n != N for _, n in segs):
        raise ValueError("segments of unequal spp")
    (S, L), order, _, _ = layout.policy(sc.has_mesh, N)
    ss = shard_slots(W, H, S, L, order, P, pixels)
    Sg = len(segs)
    c0 = torch.tensor([c for c, _ in segs], dtype=torch.int64)
    ranks = torch.arange(Sx, dtype=torch.int64)
    n_px = len(pixels)
    per_px = Sx * Sg * N
    step = max(1, RAYS_A_BATCH // per_px)
    out = np.zeros((n_px, 3), dtype=np.float64)
    for p0 in range(0, n_px, step):
        sl = slice(p0, min(n_px, p0 + step))
        p = sl.stop - sl.start

        def grid(a, dt):
            t = torch.as_tensor(np.ascontiguousarray(a[sl]), dtype=dt)
            return t[:, None, None, None].expand(p, Sx, Sg, N).reshape(-1)

        pr = torch.as_tensor(ss.pix_rank[sl], dtype=torch.int64)
        seed = ((frame_seed * 7919 + c0[None, None, :] * (P * Sx)
                 + pr[:, None, None] * Sx + ranks[None, :, None] + 1)
                & hashrng.M32)
        seed = seed[..., None].expand(p, Sx, Sg, N).reshape(-1)
        key = hashrng.tile_key(seed, grid(ss.tile, torch.int64))
        n = torch.arange(N, dtype=torch.int64)[None, None, None, :].expand(
            p, Sx, Sg, N).reshape(-1)
        rgb = trace.radiance(
            sc, config["render"], *(a.to(device) for a in (
                grid(pixels % W, torch.float32),
                grid(pixels // W, torch.float32),
                key, grid(ss.elem, torch.int64),
                grid(ss.u_elem, torch.int64), n)),
            dtype=dtype)
        for c, v in enumerate(rgb):
            v = v.float().reshape(p, Sx, Sg, N)
            acc = v[..., 0]
            for k in range(1, N):
                acc = acc + v[..., k]
            run = acc[..., 0]
            for s in range(1, Sg):
                run = run + acc[..., s]
            tot = run[:, 0]
            for r in range(1, Sx):
                tot = tot + run[:, r]
            out[sl, c] = tot.cpu().numpy().astype(np.float64)
    return (out / float(total_spp)).astype(np.float32)
