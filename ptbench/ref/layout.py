"""Which samples make a pixel of a frame: the slot layout and the segment
schedule of a render through the driver.

Frozen copy of `tile_pixel_layout` (orders "linear" and "block", both
packing axes), `default_tile`, `default_order`, `default_pack`,
`clamp_pack`, `default_pack_axis` and `_coherent_elem` of
pathtracer_tpu_torch/render/megakernel.py, and of the segment schedule of
`render_driver` and `_megakernel_segments` of pathtracer_tpu_torch/
driver.py, at commit 7dc6265, with the knobs at their defaults. These fix
the random stream of each pixel (which tile key, element and sample
numbers its samples draw), and the order in which its sums add.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


def policy(has_mesh: bool, spp_launch: int):
    """(tile (S, L), order, pack, pack axis) of a whole-image launch."""
    S, L = (8, 512) if has_mesh else (64, 256)
    order = "block" if has_mesh else "linear"
    axis = "chunk" if has_mesh else "row"
    pack = 8 if has_mesh else 1
    while pack > 1 and spp_launch % pack:
        pack //= 2
    if axis == "chunk":
        while pack > 1 and (L % pack or (L // pack) % 128):
            pack //= 2
    else:
        while pack > 1 and S % pack:
            pack //= 2
    return (S, L), order, max(1, pack), axis


def pixel_layout(W: int, H: int, S: int, L: int, order: str,
                 spp_pack: int = 1, pack_axis: str = "row") -> np.ndarray:
    """pid [rows * L] of the slots: each slot's flat pixel index, -1 for a
    padding slot; sample replicas share their pixel's id."""
    if spp_pack > 1 and pack_axis == "chunk":
        cw = L // spp_pack
        pid = pixel_layout(W, H, S, cw, order)
        return np.tile(pid.reshape(-1, cw), (1, spp_pack)).reshape(-1)
    if spp_pack > 1:
        Ss = S // spp_pack
        pid = pixel_layout(W, H, Ss, L, order)
        n_tiles = pid.size // (Ss * L)
        return np.broadcast_to(pid.reshape(n_tiles, 1, Ss * L),
                               (n_tiles, spp_pack, Ss * L)).reshape(-1)
    tile_sz = S * L
    n_pix = W * H
    if order == "block":
        side = int(math.isqrt(tile_sz))
        while tile_sz % side:
            side -= 1
        bw, bh = tile_sz // side, side
        nbx = -(-W // bw)
        nby = -(-H // bh)
        k = np.arange(nbx * nby * tile_sz)
        b = k // tile_sz
        i = k % tile_sz
        x = (b % nbx) * bw + i % bw
        y = (b // nbx) * bh + i // bw
        pid = np.where((x < W) & (y < H), y * W + x, -1)
    elif order == "linear":
        ids = np.arange(n_pix + (-n_pix) % tile_sz)
        pid = np.where(ids < n_pix, ids, -1)
    else:
        raise ValueError(f"order {order!r}")
    rows = pid.size // L
    extra = (-rows) % S
    return np.concatenate([pid, np.full(extra * L, -1, pid.dtype)])


def segments(samples: int, has_mesh: bool, spp_chunk: int = 8):
    """The driver's launches of one frame: [(first chunk c0, spp of the
    launch)], in order. A segment's seed is (frame seed * 7919 + c0 + 1)."""
    spp_chunk = min(spp_chunk, samples)
    n_chunks = max(1, (samples + spp_chunk - 1) // spp_chunk)
    seg_spp = 8 if has_mesh else 128
    seg_len = max(1, min(n_chunks, max(1, seg_spp // spp_chunk)))
    out, c = [], 0
    while c < n_chunks:
        n = min(seg_len, n_chunks - c)
        out.append((c, n * spp_chunk))
        c += n
    return out


class PixelSamples(NamedTuple):
    """The samples behind a set of pixels, flat over (pixel, replica slot,
    segment, sample of the launch), that order."""
    pixels: np.ndarray    # [P] flat pixel ids
    fx: np.ndarray        # [P, R] the slot's pixel x, y
    fy: np.ndarray
    tile: np.ndarray      # [P, R] tile index of the slot
    elem: np.ndarray      # [P, R] element index within the tile
    u_elem: np.ndarray    # [P, R] element index of the shared draws
    segs: list            # [(c0, spp of the launch)]
    n_per_seg: int        # samples a slot takes in one launch


def pixel_samples(W: int, H: int, samples: int, has_mesh: bool,
                  pixels: np.ndarray) -> PixelSamples:
    segs = segments(samples, has_mesh)
    spp_launch = segs[0][1]
    if any(s != spp_launch for _, s in segs):
        raise ValueError("segments of unequal spp")
    (S, L), order, pack, axis = policy(has_mesh, spp_launch)
    pid = pixel_layout(W, H, S, L, order, pack, axis)
    order_ = np.argsort(pid, kind="stable")
    first = np.searchsorted(pid[order_], pixels)
    R = int((pid == pixels[0]).sum())
    slots = order_[first[:, None] + np.arange(R)]      # [P, R] increasing
    if not np.all(pid[slots] == pixels[:, None]):
        raise ValueError("pixels with unequal replica counts")
    row, lane = slots // L, slots % L
    if axis == "chunk" and L >= 128:
        u_elem = (lane // 128) * 128
    else:
        u_elem = (row % S) * L
    return PixelSamples(
        pixels=pixels, fx=(pixels % W)[:, None].repeat(R, 1),
        fy=(pixels // W)[:, None].repeat(R, 1), tile=row // S,
        elem=(row % S) * L + lane, u_elem=u_elem, segs=segs,
        n_per_seg=spp_launch // pack)
