"""The reference value of chosen pixels of a frame rendered through the
driver: every sample behind each pixel traced by `trace.radiance`, summed
in the driver's order (a launch's samples of a slot in float32, the
launches of a slot in float32, the replica slots of a pixel in float64),
divided by the samples."""
from __future__ import annotations

import numpy as np
import torch

from . import hashrng, layout, trace
from .scene import RefScene

RAYS_A_BATCH = 1 << 22


def frame_pixels(sc: RefScene, config: dict, samples: int, frame_seed: int,
                 pixels: np.ndarray, device, dtype=torch.float32,
                 counts: dict = None) -> np.ndarray:
    """[P, 3] float32 values of the frame at flat pixel ids `pixels`
    (sorted), the frame seeded `frame_seed`. `dtype` is the precision of
    each path; the sums stay in the driver's. `counts` gains the work
    (trace.radiance)."""
    W, H = config["width"], config["height"]
    ps = layout.pixel_samples(W, H, samples, sc.has_mesh, pixels)
    P, R = ps.fx.shape
    Sg, N = len(ps.segs), ps.n_per_seg
    seeds = torch.tensor([(frame_seed * 7919 + c0 + 1) & hashrng.M32
                          for c0, _ in ps.segs], dtype=torch.int64)
    per_px = R * Sg * N
    step = max(1, RAYS_A_BATCH // per_px)
    out = np.zeros((P, 3), dtype=np.float64)
    for p0 in range(0, P, step):
        sl = slice(p0, min(P, p0 + step))
        p = sl.stop - sl.start

        def grid(a, dt):
            t = torch.as_tensor(np.ascontiguousarray(a[sl]), dtype=dt)
            return t[:, :, None, None].expand(p, R, Sg, N).reshape(-1)

        fx = grid(ps.fx, torch.float32)
        fy = grid(ps.fy, torch.float32)
        tile = grid(ps.tile, torch.int64)
        seed = seeds[None, None, :, None].expand(p, R, Sg, N).reshape(-1)
        key = hashrng.tile_key(seed, tile)
        n = torch.arange(N, dtype=torch.int64)[None, None, None, :].expand(
            p, R, Sg, N).reshape(-1)
        rgb = trace.radiance(
            sc, config["render"], *(a.to(device) for a in (
                fx, fy, key, grid(ps.elem, torch.int64),
                grid(ps.u_elem, torch.int64), n)),
            dtype=dtype, counts=counts)
        for c, v in enumerate(rgb):
            v = v.float().reshape(p, R, Sg, N)
            acc = v[..., 0]
            for k in range(1, N):
                acc = acc + v[..., k]
            run = acc[..., 0]
            for s in range(1, Sg):
                run = run + acc[..., s]
            tot = np.zeros(p, dtype=np.float64)
            run = run.cpu().numpy().astype(np.float64)
            for r in range(R):
                tot = tot + run[:, r]
            out[sl, c] = tot
    return (out / float(samples)).astype(np.float32)
