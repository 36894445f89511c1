"""Render driver: segmented rendering with progress logging, throughput
metrics, checkpoint/resume and synthetic-fault recovery.

Counterpart of pathtracer_tpu.driver.render_driver for the megakernel
backend. The sample budget runs in chunks of cfg.samples_per_pass; each
segment of chunks is one megakernel launch seeded by (seed, first chunk),
so a resumed render continues the same random stream bit for bit. Partial
sums stay on the device between flushes and are accumulated on the host
in float64.

A real CUDA error is not retried: it poisons the CUDA context, so no
in-process retry can recover from it. PT_FAULT_INJECT=<chunk> raises a
synthetic DeviceFailure to exercise the recovery path.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from .config import RenderConfig
from .render import megakernel as mk
from .render.camera import Camera
from .scene.pack import SceneArrays, SceneMeta

log = logging.getLogger("pathtracer_tpu_torch")


class DeviceFailure(RuntimeError):
    """Synthetic failure raised by PT_FAULT_INJECT."""


@dataclasses.dataclass
class RenderStats:
    """Throughput metrics of one render."""
    wall_s: float = 0.0
    samples: int = 0
    backend: str = ""
    segments: int = 0
    recoveries: int = 0

    @property
    def msamples_per_sec(self) -> float:
        return self.samples / self.wall_s / 1e6 if self.wall_s else 0.0

    def to_json(self, **extra) -> str:
        return json.dumps({
            "wall_s": round(self.wall_s, 3),
            "samples": self.samples,
            "msamples_per_sec": round(self.msamples_per_sec, 3),
            "backend": self.backend,
            "segments": self.segments,
            "recoveries": self.recoveries,
            **extra,
        })


def _checkpoint_meta(cfg: RenderConfig, backend: str, checkpoint_every: int,
                     layout: str) -> dict:
    # backend + interval determine the random-stream layout (segments seed
    # per segment start); layout is the slot->pixel mapping of the accum
    return {
        "width": cfg.width, "height": cfg.height,
        "samples": cfg.samples,
        "samples_per_pass": cfg.samples_per_pass,
        "seed": cfg.seed,
        "backend": backend,
        "checkpoint_every": checkpoint_every,
        "layout": layout,
    }


def _checkpoint_save(path: str, accum: np.ndarray, chunks_done: int,
                     meta: dict) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, accum=accum, chunks_done=chunks_done,
             meta=json.dumps(meta))
    os.replace(tmp, path)


def _checkpoint_load(path: str, want: dict):
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        for k, v in want.items():
            if meta.get(k, v) != v:
                raise ValueError(
                    f"checkpoint {path} was written for {k}={meta[k]}, "
                    f"current config has {v}")
        return z["accum"].copy(), int(z["chunks_done"])


def render_driver(
    scn: SceneArrays,
    meta: SceneMeta,
    camera: Camera,
    cfg: RenderConfig,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,       # in sample chunks; 0 = only at end
    resume: bool = False,
    mesh=None,
) -> tuple[np.ndarray, RenderStats]:
    """Render the full image on the scene's device, returning
    ([H, W, 3] float32, stats)."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-device rendering is not ported yet: ROADMAP queue 1, "
            "item 13 (multi-GPU)")
    if cfg.backend == "wavefront":
        raise NotImplementedError(
            "the wavefront backend is not ported yet: ROADMAP queue 1, "
            "item 12 (wavefront integrator)")
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"dtype {cfg.dtype} runs the wavefront path, not ported yet: "
            "ROADMAP queue 1, item 12 (wavefront integrator)")

    W, H = camera.width, camera.height
    dev = scn.color.device
    spp_chunk = min(cfg.samples_per_pass, cfg.samples)
    cfg = cfg.replace(samples_per_pass=spp_chunk)
    n_chunks = max(1, (cfg.samples + spp_chunk - 1) // spp_chunk)

    backend_name = "megakernel"
    S, L = mk.default_tile(meta)
    axis = mk.default_pack_axis(meta)
    pack = mk.clamp_pack(mk.default_pack(meta, spp_chunk), S, L, axis)
    order = mk.default_order(meta)
    layout_tag = "tile%dx%d:%s:pack%d%s" % (S, L, order, pack, axis)
    log.info("backend: %s on %s", backend_name, dev)

    xs, ys, pid = mk.tile_pixel_layout(W, H, S, L, order=order,
                                       spp_pack=pack, pack_axis=axis)
    px = torch.from_numpy(xs).to(dev)
    py = torch.from_numpy(ys).to(dev)
    cam_vec = torch.from_numpy(mk.build_camera_vec(camera)).to(dev)
    obj_table = torch.from_numpy(mk.build_scene_table(scn, meta)).to(dev)
    nodes, tris, shade = (torch.from_numpy(t).to(dev)
                          for t in mk.build_mesh_tables(scn, meta))
    tex = mk.texture_inputs(scn, meta, dev)

    def segment(c0: int, n: int) -> torch.Tensor:
        # independent random stream per segment, derived from (seed, c0);
        # the second slot is the global sample base, so segmented DoF
        # covers the whole sunflower spiral
        seed = (cfg.seed * 7919 + int(c0) + 1, int(c0) * spp_chunk)
        r, g, b = mk.trace_tiles(
            seed, cam_vec, obj_table, nodes, tris, shade, px, py,
            meta=meta, cfg=cfg, spp=int(n) * spp_chunk,
            total_samples=cfg.samples, tile=(S, L), spp_pack=pack,
            pack_axis=axis, **tex)
        return torch.stack([r.reshape(-1), g.reshape(-1), b.reshape(-1)],
                           dim=-1)

    ck_meta = _checkpoint_meta(cfg, backend_name, checkpoint_every,
                               layout_tag)
    accum = np.zeros((pid.shape[0], 3), dtype=np.float64)
    start_chunk = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        accum, start_chunk = _checkpoint_load(checkpoint_path, ck_meta)
        if accum.shape[0] != pid.shape[0]:
            raise ValueError(
                f"checkpoint {checkpoint_path} has {accum.shape[0]} pixel "
                f"slots, current layout has {pid.shape[0]}")
        log.info("resumed from %s at chunk %d/%d",
                 checkpoint_path, start_chunk, n_chunks)

    if checkpoint_every > 0:
        seg_len = checkpoint_every
    else:
        # cap the work of one launch (PT_SEG_SPP); the partial sums stay
        # on the device between segments. The mesh default of 8 spp is the
        # JAX driver's (set there for the TPU's watchdog), kept so both
        # drivers seed the same segments
        default_spp = "128" if not meta.has_groups else "8"
        seg_spp = int(os.environ.get("PT_SEG_SPP", default_spp))
        seg_len = max(1, min(n_chunks, max(1, seg_spp // spp_chunk)))
    stats = RenderStats(backend=backend_name)
    t_total = time.perf_counter()

    # partials flush to the host at least every PT_FLUSH_S seconds, so a
    # failure loses at most that much work plus one segment. Launches are
    # asynchronous: after queueing a segment the host waits until the one
    # before it has finished, so the clock follows the device while one
    # segment stays queued and the device does not idle
    flush_s = float(os.environ.get("PT_FLUSH_S", "60"))
    max_retries = int(os.environ.get("PT_MAX_RETRIES", "3"))
    fault_at = int(os.environ.get("PT_FAULT_INJECT", "-1"))
    fault_count = int(os.environ.get("PT_FAULT_COUNT", "1"))

    c = start_chunk
    host_base = start_chunk  # chunks reflected in the host accum
    dev_acc = None           # device-resident partial sum since last flush
    prev_done = None         # CUDA event: the previous segment finished
    failures = 0
    t_flush = time.perf_counter()

    def flush(save_ck: bool):
        nonlocal accum, dev_acc, host_base, t_flush
        if dev_acc is not None:
            accum += dev_acc.cpu().numpy().astype(np.float64)
            dev_acc = None
        host_base = c
        t_flush = time.perf_counter()
        if save_ck and checkpoint_path:
            _checkpoint_save(checkpoint_path, accum, c, ck_meta)

    while c < n_chunks:
        n = min(seg_len, n_chunks - c)
        t0 = time.perf_counter()
        try:
            if c <= fault_at < c + n and fault_count > 0:
                fault_count -= 1
                if fault_count == 0:
                    fault_at = -1
                raise DeviceFailure(f"PT_FAULT_INJECT at chunk {c}")
            out = segment(c, n)
        except DeviceFailure as exc:
            if failures >= max_retries:
                raise
            failures += 1
            stats.recoveries += 1
            log.warning(
                "device failure at chunk %d (%s); re-rendering %d chunk(s) "
                "from %d (retry %d/%d)", c, exc, c + n - host_base,
                host_base, failures, max_retries)
            # the device-resident partial is dropped with the failure
            dev_acc = None
            c = host_base
            continue
        dev_acc = out if dev_acc is None else dev_acc + out
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
            if prev_done is not None:
                prev_done.synchronize()
            prev_done = done
        failures = 0
        c += n
        stats.samples += W * H * n * spp_chunk
        stats.segments += 1
        log.info("%d/%d chunks queued, previous segment done, in %.3fs",
                 c, n_chunks, time.perf_counter() - t0)
        if checkpoint_path and checkpoint_every > 0:
            flush(save_ck=True)
        elif time.perf_counter() - t_flush > flush_s:
            flush(save_ck=False)
    flush(save_ck=checkpoint_path is not None)

    stats.wall_s = time.perf_counter() - t_total
    total_spp = n_chunks * spp_chunk
    accum = mk.untile_image(accum, pid, W, H)
    img = (accum / float(total_spp)).astype(np.float32).reshape(H, W, 3)
    return img, stats
