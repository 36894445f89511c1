"""Sharded rendering: pixels x spp over the process mesh.

Counterpart of pathtracer_tpu.parallel.render_dist. Each rank renders its
pixel shard for its slice of the sample budget on its own device; the
partial sums are added over the spp axis (all_reduce SUM) and the pixel
shards gathered over the pixels axis, so every rank ends with the whole
frame (the JAX package's _fetch). Scene tables are replicated.

- render_sharded_megakernel (render_sharded_pallas there): contiguous
  slices of whole tile rows (tile_pixel_layout's shard_granule) through
  the megakernel, K1 and its mesh, texture and NEE instantiations as the
  scene asks; an independent stream per (pixel shard, spp rank);
- render_sharded: the wavefront, its pixels interleaved over the shards
  (stride = #shards: divergent path lengths cluster spatially, striding
  spreads them), under threefry keys folded with the pixel rank, then
  with the global chunk; through integrator.render_pass, whose nearest
  hits come from K5 on the card;
- make_driver_segments: both backends as the render driver's segments.

Each sharded render is a plain function of the coordinate (pix_rank,
spp_rank), the *_shard functions, with the collectives outside it in the
mesh (parallel/mesh.py): a LogicalMesh computes every coordinate in one
process and joins them in rank order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import RenderConfig
from ..render import integrator, threefry
from ..render import megakernel as mk
from ..render.camera import Camera
from ..render.vec3 import Vec3
from ..scene.pack import SceneArrays, SceneMeta
from .mesh import RenderMesh, shard_rows


# --- the megakernel ---------------------------------------------------------

@dataclasses.dataclass
class MegakernelShards:
    """The megakernel's inputs for every shard of a mesh shape: the tables
    and the whole image's tile layout on the scene's device, padded so that
    each of the P pixel shards holds whole tiles."""
    meta: SceneMeta
    cfg: RenderConfig
    shape: tuple
    tables: tuple      # cam_vec, obj, nodes, tris, shade
    px: torch.Tensor   # [rows, L] i32
    py: torch.Tensor
    pid: np.ndarray    # slot -> flat pixel (-1 padding)
    kwargs: dict       # tile, spp_pack, pack_axis, texture inputs
    local_spp: int
    total_spp: int


def megakernel_shards(scn: SceneArrays, meta: SceneMeta, camera: Camera,
                      cfg: RenderConfig, shape, pack: bool = True
                      ) -> MegakernelShards:
    """The megakernel's inputs on a (P, S) mesh: the sample budget rounded
    up to ceil(samples / S) a spp rank (as the driver rounds), the default
    tile and order, and with `pack` the default packing, clamped to the
    local budget (the driver's segments pack none, on the row axis, as the
    JAX driver's)."""
    if not mk.supports_scene(meta):
        raise ValueError("scene not supported by the megakernel")
    P, S_axis = (int(v) for v in shape)
    S, L = mk.default_tile(meta)
    local_spp = max(1, -(-cfg.samples // S_axis))
    axis = mk.default_pack_axis(meta) if pack else "row"
    pack = (mk.clamp_pack(mk.default_pack(meta, local_spp), S, L, axis)
            if pack else 1)
    xs, ys, pid = mk.tile_pixel_layout(camera.width, camera.height, S, L,
                                       shard_granule=P,
                                       order=mk.default_order(meta),
                                       spp_pack=pack, pack_axis=axis)
    dev = scn.color.device
    tables = tuple(torch.from_numpy(t).to(dev) for t in (
        mk.build_camera_vec(camera), mk.build_scene_table(scn, meta),
        *mk.build_mesh_tables(scn, meta)))
    return MegakernelShards(
        meta, cfg, (P, S_axis), tables, torch.from_numpy(xs).to(dev),
        torch.from_numpy(ys).to(dev), pid,
        dict(tile=(S, L), spp_pack=pack, pack_axis=axis,
             **mk.texture_inputs(scn, meta, dev)),
        local_spp, local_spp * S_axis)


def megakernel_shard(sh: MegakernelShards, pix_rank: int, spp_rank: int,
                     c0: int = 0, spp: int = None) -> torch.Tensor:
    """Shard (pix_rank, spp_rank)'s radiance sums, [its slots, 3] f32: its
    tile rows at `spp` samples (local_spp by default) under the seed
    cfg.seed*7919 + c0*P*S + pix_rank*S + spp_rank + 1, from the sample
    base c0*chunk + spp_rank*spp: an independent stream per (segment,
    shard), the segment at chunk c0 of the driver (render_dist.py:224-233
    and :380-386 of the JAX package)."""
    P, S_axis = sh.shape
    spp = sh.local_spp if spp is None else spp
    seed = (sh.cfg.seed * 7919 + c0 * P * S_axis + pix_rank * S_axis
            + spp_rank + 1, c0 * sh.cfg.samples_per_pass + spp_rank * spp)
    r, g, b = mk.trace_tiles(
        seed, *sh.tables, shard_rows(sh.px, pix_rank, P),
        shard_rows(sh.py, pix_rank, P), meta=sh.meta, cfg=sh.cfg, spp=spp,
        total_samples=sh.cfg.samples, **sh.kwargs)
    return torch.stack([r.reshape(-1), g.reshape(-1), b.reshape(-1)],
                       dim=-1)


def render_sharded_megakernel(scn: SceneArrays, meta: SceneMeta,
                              camera: Camera, cfg: RenderConfig,
                              mesh: RenderMesh) -> np.ndarray:
    """Distributed megakernel render (render_sharded_pallas there): each
    rank runs the megakernel on its shard; the spp axis splits the sample
    budget and adds the partials. Returns [H, W, 3] float32, the same on
    every rank."""
    sh = megakernel_shards(scn, meta, camera, cfg,
                           (mesh.shape["pixels"], mesh.shape["spp"]))
    flat = mesh.total(mesh.local(lambda p, s: megakernel_shard(sh, p, s)))
    img = mk.untile_image(flat.cpu().numpy(), sh.pid, camera.width,
                          camera.height)
    return img.reshape(camera.height, camera.width, 3) / float(sh.total_spp)


# --- the wavefront ----------------------------------------------------------

def interleaved_pixels(W: int, H: int, n_shards: int, device):
    """(px, py, perm, pad): the W*H pixels padded to a multiple of
    8 n_shards (padding repeats the last row) and reordered so that
    shard i's contiguous slice holds pixels i, i + n_shards, ..."""
    n_pix = W * H
    pad = (-n_pix) % (n_shards * 8)
    ids = np.arange(n_pix + pad)
    xs = ids % W
    ys = np.minimum(ids // W, H - 1)
    perm = ids.reshape(-1, n_shards).T.reshape(-1)
    return (torch.from_numpy(xs[perm].astype(np.int32)).to(device),
            torch.from_numpy(ys[perm].astype(np.int32)).to(device),
            perm, pad)


def uninterleave(flat: np.ndarray, perm: np.ndarray, n_pix: int
                 ) -> np.ndarray:
    """Undo interleaved_pixels' order and drop its padding."""
    out = np.empty((perm.shape[0], flat.shape[-1]), dtype=flat.dtype)
    out[perm] = flat
    return out[:n_pix]


@dataclasses.dataclass
class WavefrontShards:
    """render_sharded's inputs for every shard of a mesh shape."""
    scn: SceneArrays
    meta: SceneMeta
    cfg: RenderConfig   # samples_per_pass = the chunk
    shape: tuple
    cam: object
    px: torch.Tensor
    py: torch.Tensor
    perm: np.ndarray
    key: torch.Tensor
    route: integrator.IntersectRoute
    n_chunks: int
    total_spp: int


def wavefront_shards(scn: SceneArrays, meta: SceneMeta, camera: Camera,
                     cfg: RenderConfig, shape, key=None) -> WavefrontShards:
    """The inputs of render_sharded on a (P, S) mesh: chunks of
    min(samples_per_pass, samples // S) samples, their count rounded up to
    a multiple of S (render_dist.py:95-101 of the JAX package)."""
    P, S_axis = (int(v) for v in shape)
    spp_chunk = min(cfg.samples_per_pass, max(1, cfg.samples // S_axis))
    cfg = cfg.replace(samples_per_pass=spp_chunk)
    n_chunks = max(1, cfg.samples // spp_chunk)
    n_chunks = -(-n_chunks // S_axis) * S_axis
    dev = scn.color.device
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    px, py, perm, _ = interleaved_pixels(camera.width, camera.height, P, dev)
    return WavefrontShards(
        scn, meta, cfg, (P, S_axis), camera.pack(dtype, dev), px, py, perm,
        threefry.prng_key(cfg.seed) if key is None else key,
        integrator.intersect_route(scn, meta, cfg), n_chunks,
        n_chunks * spp_chunk)


def wavefront_shard(sh: WavefrontShards, pix_rank: int, spp_rank: int,
                    c0: int = 0, n: int = None) -> torch.Tensor:
    """Shard (pix_rank, spp_rank)'s radiance sums over global chunks
    c0 + i*S + spp_rank of [c0, c0 + n) (all chunks by default), [its
    pixels, 3]: chunk gc under fold_in(fold_in(key, pix_rank), gc) from
    sample gc * chunk (render_dist.py:56-72 of the JAX package)."""
    P, S_axis = sh.shape
    n = sh.n_chunks if n is None else n
    px, py = shard_rows(sh.px, pix_rank, P), shard_rows(sh.py, pix_rank, P)
    key = threefry.fold_in(sh.key, pix_rank)
    chunk = sh.cfg.samples_per_pass
    acc = Vec3.zeros((px.shape[0],), sh.cam.inverse.dtype, px.device)
    for i in range(n // S_axis):
        gc = c0 + i * S_axis + spp_rank
        acc = acc + integrator.render_pass(
            sh.scn, sh.meta, sh.cfg, sh.cam, px, py, gc * chunk, chunk,
            threefry.fold_in(key, gc), sh.route)
    return acc.to_array()


def render_sharded(scn: SceneArrays, meta: SceneMeta, camera: Camera,
                   cfg: RenderConfig, mesh: RenderMesh, key=None
                   ) -> np.ndarray:
    """Full-image wavefront render over the mesh. Returns [H, W, 3]
    float32, the same on every rank."""
    sh = wavefront_shards(scn, meta, camera, cfg,
                          (mesh.shape["pixels"], mesh.shape["spp"]), key)
    flat = mesh.total(mesh.local(lambda p, s: wavefront_shard(sh, p, s)))
    flat = flat.cpu().numpy().astype(np.float32) / float(sh.total_spp)
    W, H = camera.width, camera.height
    return uninterleave(flat, sh.perm, W * H).reshape(H, W, 3)


# --- the render driver's segments -------------------------------------------

class DriverSegments(NamedTuple):
    """What render_driver(mesh=) runs: segment(c0, n) -> this rank's
    partial sums over chunks [c0, c0 + n) (n a multiple of the spp axis)
    on the device (mesh.local); fetch(sums of segments) -> the whole
    frame's [n_slots, 3] as numpy, added over the spp axis and gathered
    over the pixels axis (mesh.total); finalize([n_slots, 3]) -> [H*W, 3]
    in image order; the slot count and the checkpoint's layout tag."""
    segment: Callable
    fetch: Callable
    finalize: Callable
    n_slots: int
    layout_tag: str


def make_driver_segments(scn: SceneArrays, meta: SceneMeta, camera: Camera,
                         cfg: RenderConfig, mesh: RenderMesh,
                         use_megakernel: bool) -> DriverSegments:
    """The render driver's per-segment compute over the mesh
    (make_driver_segments of the JAX package): the megakernel when the
    driver takes it, else the wavefront; cfg.samples_per_pass is the
    chunk. The driver keeps its chunk loop, checkpoints, recovery and
    metrics. The collectives run where the driver flushes its running sum
    to the host (at the end, after PT_FLUSH_S, at every checkpoint), not
    every segment: the partial sums stay on each rank's device until then
    (the JAX package adds them over the spp axis every segment)."""
    W, H = camera.width, camera.height
    P, S_axis = mesh.shape["pixels"], mesh.shape["spp"]

    def fetch(acc):
        return mesh.total(acc).cpu().numpy()

    if use_megakernel:
        sh = megakernel_shards(scn, meta, camera, cfg, (P, S_axis),
                               pack=False)

        def segment(c0, n):
            return mesh.local(lambda p, s: megakernel_shard(
                sh, p, s, c0, (n // S_axis) * cfg.samples_per_pass))

        S, L = sh.kwargs["tile"]
        return DriverSegments(
            segment, fetch,
            lambda acc: mk.untile_image(acc, sh.pid, W, H), sh.pid.shape[0],
            "tile%dx%d:%s:pack1row:shards%d" % (S, L, mk.default_order(meta),
                                                P))

    wf = wavefront_shards(scn, meta, camera, cfg, (P, S_axis))
    wf = dataclasses.replace(wf, cfg=cfg)

    def segment(c0, n):
        return mesh.local(lambda p, s: wavefront_shard(wf, p, s, c0, n))

    return DriverSegments(
        segment, fetch, lambda acc: uninterleave(acc, wf.perm, W * H),
        wf.px.shape[0], "interleave%d" % P)
