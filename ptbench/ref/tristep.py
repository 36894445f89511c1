"""The reference of the triangle-colour training step: the differentiable
megakernel's forward over every slot of its launch, its masked mean
squared error against a target, and the loss's gradient with respect to
the triangle colours by autograd through `trace.radiance`.

The launch is the one the program's `render.grad.make_diff_render_tri`
makes in the triangle training job: tile (8, 512), the mesh scenes' block
order, no sample packing, `spp` samples a slot in float32 order, one seed
for the target and every step (common random numbers). Slots run in
blocks, each block's loss added and its gradient accumulated, so that
memory stays bounded.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import hashrng, layout, trace
from .scene import RefScene

TILE = (8, 512)
RAYS_A_BLOCK = 1 << 23


class Slots(NamedTuple):
    fx: torch.Tensor      # [Q] f32 pixel of each slot
    fy: torch.Tensor
    tile: torch.Tensor    # [Q] int64
    elem: torch.Tensor
    u_elem: torch.Tensor
    valid: torch.Tensor   # [Q] f32: 1 for a slot on a pixel


def slots(W: int, H: int) -> Slots:
    """The launch's slots, in slot order (a padding slot renders the last
    pixel and is masked out of the loss)."""
    S, L = TILE
    pid = layout.pixel_layout(W, H, S, L, "block")
    i = np.arange(pid.size)
    row, lane = i // L, i % L
    p = np.where(pid >= 0, pid, W * H - 1)
    return Slots(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        (p % W).astype(np.float32), (p // W).astype(np.float32), row // S,
        (row % S) * L + lane, (row % S) * L,
        (pid >= 0).astype(np.float32))))


def _block(sc, render, sl: Slots, a: int, b: int, seed0: int, spp: int,
           tri_color, device, dtype):
    """The per-slot means (r, g, b) of slots [a, b)."""
    q = b - a

    def grid(t):
        return t[a:b, None].expand(q, spp).reshape(-1).to(device)

    n = torch.arange(spp, dtype=torch.int64)[None, :].expand(q, spp)
    rgb = trace.radiance(
        sc, render, grid(sl.fx), grid(sl.fy),
        hashrng.tile_key(seed0, grid(sl.tile)), grid(sl.elem),
        grid(sl.u_elem), n.reshape(-1).to(device), dtype=dtype,
        tri_color=tri_color)
    out = []
    for v in rgb:
        v = v.float().reshape(q, spp)
        acc = v[:, 0]
        for k in range(1, spp):
            acc = acc + v[:, k]
        out.append(acc * (1.0 / float(spp)))
    return out


def render(sc: RefScene, config: dict, seed0: int, spp: int, tri_color,
           device, dtype=torch.float32):
    """Every slot's mean (r, g, b), no gradient."""
    sl = slots(config["width"], config["height"])
    step = max(1, RAYS_A_BLOCK // spp)
    parts = []
    with torch.no_grad():
        for a in range(0, sl.fx.shape[0], step):
            parts.append(_block(sc, config["render"], sl, a,
                                min(a + step, sl.fx.shape[0]), seed0, spp,
                                tri_color, device, dtype))
    return [torch.cat([p[c] for p in parts]) for c in range(3)]


def loss_and_grad(sc: RefScene, config: dict, seed0: int, spp: int,
                  tri_color, target, device, dtype=torch.float32,
                  every: int = 1):
    """(loss, gradient of tri_color): sum over channels and slots of
    ((mean - target) * valid)^2 over 3 * valid slots. `every` keeps every
    every-th slot alone (a fault: part of the batch left out, the mean
    over the rest)."""
    sl = slots(config["width"], config["height"])
    keep = torch.zeros_like(sl.valid)
    keep[::every] = 1.0
    valid = (sl.valid * keep).to(device)
    n_valid = float(valid.sum())
    leaf = tri_color.detach().requires_grad_(True)
    step = max(1, RAYS_A_BLOCK // spp)
    total = 0.0
    for a in range(0, sl.fx.shape[0], step):
        b = min(a + step, sl.fx.shape[0])
        with torch.enable_grad():
            got = _block(sc, config["render"], sl, a, b, seed0, spp, leaf,
                         device, dtype)
            part = sum(torch.sum(((x - t[a:b]) * valid[a:b]) ** 2)
                       for x, t in zip(got, target)) / (3.0 * n_valid)
            part.backward()
        total += float(part.detach())
    grad = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
    return total, grad.detach()
