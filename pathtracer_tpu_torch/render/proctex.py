"""Procedural texture programs, evaluated on the host in numpy.

Counterpart of pathtracer_tpu.render.proctex (its ``xp=numpy`` branch).
The repository ships no texture images, so assets.py builds every texture
from these deterministic programs: closed-form functions of the integer
texel coordinate over an integer-hash value noise. The JAX package also
evaluates them inside its TPU kernel, because a TPU vector lane cannot
gather texels; here the images are built once on the host into the texel
pool (scene/pack.py), and the CUDA kernel fetches texels from it. The
images equal the JAX package's bit for bit: both are the same numpy
arithmetic (uint32 hashing, float32 everywhere else).

A texture is described by a hashable descriptor ``(prog_name, (param,
...))`` carried in SceneMeta; PROGRAMS maps the name to its per-texel
function ``fn(ix, iy, h, w, params) -> (r, g, b)`` with rgb floats in
[0, 1] before the rgb8 quantization of the pool (``quantize8``).
Sampling semantics (normalized coords, REPEAT wrap, bilinear) follow
tracer.cl:829; the images stand in for the reference's missing assets
(texturedplanets.go:124-129).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _mulc(a, v: int):
    """Wrapping 32-bit multiply by a constant."""
    return (a * np.uint32(v)).astype(np.uint32)


def hash01(ix, iy, seed: int):
    """Uniform [0,1) from uint32 coords: xorshift-multiply mixer (the
    murmur3-finalizer family). Returns f32 with 23 random bits."""
    h = _mulc(ix, 0x27D4EB2D)
    h = h ^ _mulc(iy, 0x165667B1)
    h = h ^ np.uint32(0x9E3779B9 * (seed + 1) & 0xFFFFFFFF)
    h = h ^ (h >> np.uint32(15))
    h = _mulc(h, 0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = _mulc(h, 0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    return (h >> np.uint32(9)).astype(np.float32) * np.float32(1.0 / 8388608.0)


def _fmod_pos(af, m: int):
    """a mod m for non-negative float-held integers below 2^23 (exact)."""
    mf = np.float32(m)
    return af - mf * np.floor(af * np.float32(1.0 / m))


def value_noise(fx, fy, cells: int, h: int, w: int, seed: int):
    """Smoothstep-interpolated value noise on a (cells x cells) hash grid,
    evaluated at float texel coords (fx, fy) in [0,w) x [0,h); the grid
    value at integer corner (gx, gy) is hash01(gx, gy, seed)."""
    ty = fy * np.float32(cells / h)
    tx = fx * np.float32(cells / w)
    y0f = np.floor(ty)
    x0f = np.floor(tx)
    sy = ty - y0f
    sx = tx - x0f
    sy = sy * sy * (np.float32(3.0) - np.float32(2.0) * sy)
    sx = sx * sx * (np.float32(3.0) - np.float32(2.0) * sx)
    y0 = y0f.astype(np.uint32)
    x0 = x0f.astype(np.uint32)
    a = hash01(x0, y0, seed)
    b = hash01(x0 + 1, y0, seed)
    c = hash01(x0, y0 + 1, seed)
    d = hash01(x0 + 1, y0 + 1, seed)
    omy = np.float32(1.0) - sy
    omx = np.float32(1.0) - sx
    return a * omy * omx + b * omy * sx + c * sy * omx + d * sy * sx


def quantize8(v):
    """The texel pool's rgb8 quantization (pack._build_texel_pool):
    round-half-even to 8 bits, back to [0,1] as q * f32(1/255)."""
    q = np.clip(np.round(v * np.float32(255.0)), 0.0, 255.0)
    return q.astype(np.float32) * np.float32(1.0 / 255.0)


# ---------------------------------------------------------------------------
# Texture programs. fn(ixf, iyf, h, w, params) -> (r, g, b) in [0,1].
# ixf/iyf are float-held integer texel coords (exact below 2^23).
# ---------------------------------------------------------------------------


def _checker(ixf, iyf, h, w, params):
    n, c1, c2 = params
    cell = _fmod_pos(np.floor(iyf * np.float32(n / h))
                     + np.floor(ixf * np.float32(n / w)), 2)
    sel = cell < 0.5
    return tuple(np.where(sel, np.float32(a), np.float32(b))
                 for a, b in zip(c1, c2))


def _squares(ixf, iyf, h, w, params):
    """Grout lines over noisy concrete (concrete_squares.png role)."""
    (seed,) = params
    base = np.float32(0.55) + np.float32(0.25) * value_noise(
        ixf, iyf, 16, h, w, seed)
    line = (_fmod_pos(iyf, h // 8) < 3.0) | (_fmod_pos(ixf, w // 8) < 3.0)
    g = np.where(line, base * np.float32(0.45), base)
    return g, g, g


def _squares_nm(ixf, iyf, h, w, params):
    """Beveled grout-line normal map (concrete_squares_nm2.png role): the
    texel is the object-space normal (tracer.cl:907-911)."""
    px = _fmod_pos(ixf, w // 8)
    py = _fmod_pos(iyf, h // 8)
    nx = np.where(px < 3.0, np.float32(0.1),
                  np.where(px > np.float32((w // 8) - 4), np.float32(0.5),
                           np.float32(0.3)))
    nz = np.where(py < 3.0, np.float32(0.1),
                  np.where(py > np.float32((h // 8) - 4), np.float32(0.5),
                           np.float32(0.3)))
    ny = np.full_like(nx, np.float32(0.9))
    return nx, ny, nz


def _cobblestone(ixf, iyf, h, w, params):
    s1, s2 = params
    n1 = value_noise(ixf, iyf, 24, h, w, s1)
    n2 = value_noise(ixf, iyf, 6, h, w, s2)
    g = np.float32(0.35) + np.float32(0.3) * n1 + np.float32(0.2) * n2
    return g, g * np.float32(0.95), g * np.float32(0.85)


def _floorboards(ixf, iyf, h, w, params):
    (seed,) = params
    grain = value_noise(ixf, iyf, 64, h, w, seed)
    plank = np.floor(iyf * np.float32(8.0 / h)) * np.float32(1.0 / 8.0)
    g = np.float32(0.45) + np.float32(0.12) * grain + np.float32(0.08) * plank
    line = _fmod_pos(iyf, h // 8) < 2.0
    g = np.where(line, g * np.float32(0.5), g)
    return g, g * np.float32(0.72), g * np.float32(0.45)


def _planet(ixf, iyf, h, w, params):
    """2:1 equirectangular planet: continents over ocean + polar caps."""
    (seed,) = params
    n = value_noise(ixf, iyf, 12, h, w, seed) \
        + np.float32(0.5) * value_noise(ixf, iyf, 48, h, w, seed + 1)
    land = n > np.float32(0.75)
    # |linspace(-1,1,h)[iy]| > 0.88
    lat = np.abs(np.float32(-1.0) + iyf * np.float32(2.0 / (h - 1)))
    polar = lat > np.float32(0.88)
    ocean = (0.05, 0.15, 0.45)
    landc = (0.15, 0.5, 0.2)
    icec = (0.95, 0.95, 0.98)
    out = []
    for k in range(3):
        v = np.where(land, np.float32(landc[k]), np.float32(ocean[k]))
        out.append(np.where(polar, np.float32(icec[k]), v))
    return tuple(out)


def _jupiter(ixf, iyf, h, w, params):
    (seed,) = params
    yy = iyf * np.float32(1.0 / (h - 1))
    bands = np.float32(0.5) + np.float32(0.25) * np.sin(yy * np.float32(40.0)) \
        + np.float32(0.1) * value_noise(ixf, iyf, 20, h, w, seed)
    b = np.clip(bands, np.float32(0.0), np.float32(1.0))
    return b, b * np.float32(0.8), b * np.float32(0.6)


def _sky(ixf, iyf, h, w, params):
    """alps_field_8k.png role: sky gradient + ground band + sun disc."""
    v = iyf * np.float32(1.0 / (h - 1))
    top = (0.35, 0.55, 0.95)
    bot = (0.85, 0.9, 1.0)
    groundc = (0.25, 0.4, 0.18)
    sunc = (1.0, 0.98, 0.9)
    ground = v > np.float32(0.62)
    dy = iyf - np.float32(0.25 * h)
    dx = ixf - np.float32(0.7 * w)
    sun = dy * dy + dx * dx < np.float32((0.03 * h) ** 2)
    out = []
    for k in range(3):
        c = (np.float32(1.0) - v) * np.float32(top[k]) + v * np.float32(bot[k])
        c = np.where(ground, np.float32(groundc[k]), c)
        out.append(np.where(sun, np.float32(sunc[k]), c))
    return tuple(out)


def _cube_cross(ixf, iyf, h, w, params):
    """shrine_cubemap.jpeg role: 4x3 cross, gradient side faces with
    per-face tints, flat top (sky) and bottom (ground)."""
    (face,) = params
    skyc = (0.4, 0.6, 0.95)
    groundc = (0.3, 0.25, 0.2)
    tints = ((1.0, 0.9, 0.8), (0.9, 1.0, 0.9),
             (0.8, 0.9, 1.0), (1.0, 1.0, 0.85))
    ff = np.float32(face)
    col = np.floor(ixf * np.float32(1.0 / face))  # 0..3
    mid = (iyf >= ff) & (iyf < np.float32(2 * face))
    topf = (iyf < ff) & (col == 1.0)
    botf = (iyf >= np.float32(2 * face)) & (col == 1.0)
    # vertical blend within the middle row: linspace(0,1,face)[iy-face]
    vv = (iyf - ff) * np.float32(1.0 / (face - 1))
    out = []
    for k in range(3):
        grad = (np.float32(1.0) - vv) * np.float32(skyc[k]) \
            + vv * np.float32(groundc[k])
        tint = np.zeros_like(ixf)
        for t in range(4):
            tint = np.where(col == np.float32(t), np.float32(tints[t][k]),
                            tint)
        c = np.where(mid, grad * tint, np.zeros_like(ixf))
        c = np.where(topf, np.float32(skyc[k]), c)
        c = np.where(botf, np.float32(groundc[k]), c)
        out.append(c)
    return tuple(out)


PROGRAMS = {
    "checker": _checker,
    "squares": _squares,
    "squares_nm": _squares_nm,
    "cobblestone": _cobblestone,
    "floorboards": _floorboards,
    "planet": _planet,
    "jupiter": _jupiter,
    "sky": _sky,
    "cube_cross": _cube_cross,
}


def eval_image(desc: Tuple, h: int, w: int) -> np.ndarray:
    """[h, w, 3] f32 image of program `desc`, before the rgb8
    quantization that the pool packer applies."""
    iy, ix = np.mgrid[0:h, 0:w]
    ixf = ix.astype(np.float32)
    iyf = iy.astype(np.float32)
    name, params = desc
    r, g, b = PROGRAMS[name](ixf, iyf, h, w, params)
    out = np.stack([np.broadcast_to(r, (h, w)),
                    np.broadcast_to(g, (h, w)),
                    np.broadcast_to(b, (h, w))], axis=-1)
    return np.ascontiguousarray(out.astype(np.float32))


class ProcImage(np.ndarray):
    """[H, W, 3] f32 image that remembers its procedural descriptor. The
    packer records it in SceneMeta.obj_tex as the JAX package does (there
    it lets the TPU kernel compute the texels); file-loaded images are
    plain ndarrays (proc is None)."""
    proc: "Tuple | None" = None

    @staticmethod
    def wrap(img: np.ndarray, desc: Tuple) -> "ProcImage":
        out = np.asarray(img, dtype=np.float32).view(ProcImage)
        out.proc = desc
        return out

    def __array_finalize__(self, obj):
        if obj is not None and self.ndim != 3:
            # reductions and slices are ordinary arrays; keep the
            # descriptor only on whole-image views
            self.proc = None
        else:
            self.proc = getattr(obj, "proc", None)


def make(desc: Tuple, h: int, w: int) -> ProcImage:
    """Build a descriptor-carrying procedural image."""
    return ProcImage.wrap(eval_image(desc, h, w), desc)
