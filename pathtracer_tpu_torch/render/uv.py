"""UV mapping and texture sampling (SoA forms).

Counterpart of pathtracer_tpu.render.uv: the cube-cross UV and spherical
map (tracer.cl:113-213) and bilinear REPEAT sampling with the OpenCL
sampler's normalized coordinates (tracer.cl:829), from the per-kind float
atlases (`sample_texture`) or from the flat rgb8 texel pool
(`sample_texture_pool`, four taps or, with the quad pool, one row).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .vec3 import Vec3


def spherical_map(p: Vec3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit-sphere point -> (u, v) in [0,1) (tracer.cl:178-213)."""
    theta = torch.arctan2(p.x, p.z)
    radius = p.norm()
    phi = torch.arccos(torch.clamp(p.y / radius, -1.0, 1.0))
    raw_u = theta / (2.0 * math.pi)
    u = 1.0 - (raw_u + 0.5)
    v = 1.0 - phi / math.pi
    return u, v


def _fmod(a: torch.Tensor, b: float) -> torch.Tensor:
    """C fmod (truncated, sign of dividend) as the kernel's cube UV uses."""
    return a - b * torch.trunc(a / b)


def cube_uv(p: Vec3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cube-cross UV for a unit-cube local point (tracer.cl:113-175); face
    layout as in pathtracer_tpu.render.uv.cube_uv."""
    x, y, z = p.x, p.y, p.z
    coord = p.abs().max_component()

    two_thirds = 0.6666666
    third = 0.333333
    v_mid = two_thirds - (_fmod(y + 1.0, 2.0) / 2.0) * third

    u_right = 0.5 + (_fmod(1.0 - z, 2.0) / 2.0) * 0.25
    u_left = (_fmod(z + 1.0, 2.0) / 2.0) * 0.25
    u_top = 0.25 + (_fmod(x + 1.0, 2.0) / 2.0) * 0.25
    v_top = 1.0 - (_fmod(1.0 - z, 2.0) / 2.0) * third
    u_bottom = u_top
    v_bottom = (_fmod(z + 1.0, 2.0) / 2.0) * third
    u_front = u_top
    u_back = 0.75 + (_fmod(1.0 - x, 2.0) / 2.0) * 0.25

    # selection cascade (first match wins; order of tracer.cl:158-174)
    sel_right = coord == x
    sel_left = (~sel_right) & (coord == -x)
    sel_top = (~sel_right) & (~sel_left) & (coord == y)
    sel_bottom = (~sel_right) & (~sel_left) & (~sel_top) & (coord == -y)
    sel_front = ((~sel_right) & (~sel_left) & (~sel_top) & (~sel_bottom)
                 & (coord == z))

    u = torch.where(sel_right, u_right,
        torch.where(sel_left, u_left,
        torch.where(sel_top, u_top,
        torch.where(sel_bottom, u_bottom,
        torch.where(sel_front, u_front, u_back)))))
    v = torch.where(sel_right | sel_left | sel_front, v_mid,
        torch.where(sel_top, v_top,
        torch.where(sel_bottom, v_bottom, v_mid)))
    return u, v


def _bilinear_coords(w, h, layer, n, u, v):
    """OpenCL normalized-coordinate linear filtering with REPEAT wrap:
    texel centers at (i + 0.5) / W (tracer.cl:829 sampler semantics)."""
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = torch.remainder(x0.to(torch.int32), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.remainder(y0.to(torch.int32), h)
    y1i = torch.remainder(y0i + 1, h)
    li = torch.clamp(layer, 0, n - 1)
    return x0i, x1i, y0i, y1i, tx, ty, li


def sample_texture(atlas: torch.Tensor, layer: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor) -> Vec3:
    """Bilinear sample from a channel-leading [3, n, H, W] float atlas;
    layer/u/v [R]. The JAX package's differentiable path. Each tap is one
    index_select of the [3, n*H*W] view (the same values as indexing the
    four axes): its backward adds with index_add_, where advanced
    indexing's sorts the indices and adds each run of equal ones in turn,
    which serializes the many rays that fetch one texel."""
    _, n, h, w = atlas.shape
    x0i, x1i, y0i, y1i, tx, ty, li = _bilinear_coords(w, h, layer, n, u, v)
    li, x0i, x1i, y0i, y1i = (a.long() for a in (li, x0i, x1i, y0i, y1i))
    flat = atlas.reshape(3, n * h * w)
    row0 = (li * h + y0i) * w
    row1 = (li * h + y1i) * w
    taps = [torch.index_select(flat, 1, i) for i in (
        row0 + x0i, row0 + x1i, row1 + x0i, row1 + x1i)]

    def chan(c):
        c00, c01, c10, c11 = (t[c] for t in taps)
        top = c00 * (1.0 - tx) + c01 * tx
        bot = c10 * (1.0 - tx) + c11 * tx
        return top * (1.0 - ty) + bot * ty

    return Vec3(chan(0), chan(1), chan(2))


def _take_clip(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pool[idx] with out-of-range indices clamped (jnp.take mode='clip')."""
    return pool[torch.clamp(idx, 0, pool.shape[0] - 1).long()]


def sample_texture_pool(pool_u32: torch.Tensor, base: torch.Tensor,
                        w: torch.Tensor, h: torch.Tensor,
                        u: torch.Tensor, v: torch.Tensor,
                        pool_quad_u32: Optional[torch.Tensor] = None
                        ) -> Vec3:
    """Bilinear sample from the flat rgb8 texel pool (scene/pack.py
    _build_texel_pool) with per-ray (base, w, h) as floats (exact below
    2^24); the same REPEAT + LINEAR semantics as sample_texture, in u's
    dtype. With `pool_quad_u32` ([T, 4]: each texel's bilinear footprint
    [c00, c01, c10, c11] with the texture's wrap baked in) one row gather
    replaces the four taps, with the same result."""
    dt = u.dtype
    wi = w.to(torch.int32)
    hi = h.to(torch.int32)
    bi = base.to(torch.int32)
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0).to(dt)
    ty = (fy - y0).to(dt)
    x0i = torch.remainder(x0.to(torch.int32), wi)
    x1i = torch.remainder(x0i + 1, wi)
    y0i = torch.remainder(y0.to(torch.int32), hi)
    y1i = torch.remainder(y0i + 1, hi)
    scale = torch.as_tensor(1.0 / 255.0, dtype=dt, device=u.device)

    def unpack(p):
        # rgb8 texels stay below 2^24, so the int32 view keeps their bits
        return Vec3(
            (p & 0xFF).to(dt) * scale,
            ((p >> 8) & 0xFF).to(dt) * scale,
            ((p >> 16) & 0xFF).to(dt) * scale,
        )

    if pool_quad_u32 is not None:
        rows = _take_clip(pool_quad_u32.view(torch.int32),
                          bi + y0i * wi + x0i)
        c00, c01, c10, c11 = (unpack(rows[:, k]) for k in range(4))
    else:
        pool = pool_u32.view(torch.int32)

        def tap(yi, xi):
            return unpack(_take_clip(pool, bi + yi * wi + xi))

        c00 = tap(y0i, x0i)
        c01 = tap(y0i, x1i)
        c10 = tap(y1i, x0i)
        c11 = tap(y1i, x1i)
    top = c00 * (1.0 - tx) + c01 * tx
    bot = c10 * (1.0 - tx) + c11 * tx
    return top * (1.0 - ty) + bot * ty
