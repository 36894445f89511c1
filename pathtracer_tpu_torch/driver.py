"""Render driver: segmented rendering with progress logging, throughput
metrics, checkpoint/resume, synthetic-fault recovery and profiler traces.

Counterpart of pathtracer_tpu.driver.render_driver, for both backends.
The sample budget runs in chunks of cfg.samples_per_pass, grouped into
segments:

- megakernel: each segment is one launch seeded by (seed, first chunk);
- wavefront (render/integrator.py): each segment sums the render passes
  of its chunks under fold_in(key, chunk), in row blocks of
  cfg.rows_per_pass, block b under fold_in(key, 1000003 + b), as the JAX
  driver's segment_wavefront.

Either way a resumed render continues the same random stream bit for bit.
Under a mesh (`mesh=`, parallel/mesh.py) the segments are
parallel.render_dist.make_driver_segments': each rank renders its pixel
shard for its slice of each segment, and a flush adds the ranks' partial
sums and gathers the whole frame on every rank. The chunk schedule is
rounded to the spp axis; the backend tag gains "@PxS", so that a
checkpoint of one mesh shape does not resume on another; after each
segment the ranks vote on the host (a gloo group, no wait for the card)
whether any failed, so that all rewind together, and whether any is due a
time-based flush (a collective every rank must join). Rank 0 alone reads
the checkpoint to resume from (every rank takes what it read), writes the
checkpoint (the others wait at a barrier) and writes the profile.
Partial sums stay on the device between flushes and are accumulated on
the host in float64. `profile_dir` wraps the segment loop in
torch.profiler (CPU and CUDA activities) and writes a Chrome trace there,
in which "pt.segment" spans each segment's work and "pt.accumulate" the
stacking of its sums and their add to the running sum.

A real CUDA error is not retried: it poisons the CUDA context, so no
in-process retry can recover from it. PT_FAULT_INJECT=<chunk> raises a
synthetic DeviceFailure to exercise the recovery path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

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


def use_megakernel(meta: SceneMeta, cfg: RenderConfig) -> bool:
    """The backend a render takes: the megakernel for "pallas", and for
    "auto" on every scene it supports in f32 without the per-ray probe;
    else the wavefront integrator."""
    return cfg.backend == "pallas" or (
        cfg.backend == "auto" and cfg.dtype == "float32"
        and cfg.debug_ray < 0 and mk.supports_scene(meta))


@contextlib.contextmanager
def _profiler(profile_dir: Optional[str]):
    """torch.profiler over CPU and, where there is a card, CUDA activity,
    writing a Chrome trace, `profile_dir`/trace.json, on exit; nothing
    without a directory."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def render_driver(
    scn: SceneArrays,
    meta: SceneMeta,
    camera: Camera,
    cfg: RenderConfig,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,       # in sample chunks; 0 = only at end
    resume: bool = False,
    profile_dir: Optional[str] = None,
    mesh=None,
) -> tuple[np.ndarray, RenderStats]:
    """Render the full image on the scene's device, returning
    ([H, W, 3] float32, stats). The scene's dtype is cfg.dtype's. `mesh`
    (a parallel.mesh.RenderMesh) shards each segment over its ranks; every
    rank returns the whole image."""
    W, H = camera.width, camera.height
    dev = scn.color.device
    spp_chunk = min(cfg.samples_per_pass, cfg.samples)
    cfg = cfg.replace(samples_per_pass=spp_chunk)
    n_chunks = max(1, (cfg.samples + spp_chunk - 1) // spp_chunk)
    spp_axis = 1

    def fetch(acc):
        return acc.cpu().numpy()

    if mesh is not None:
        from .parallel.render_dist import make_driver_segments

        # the chunk schedule is rounded to the spp axis, so that every rank
        # renders an equal share of each segment; the mesh shape is part of
        # the random stream's layout, so the checkpoint's backend tag has it
        spp_axis = mesh.shape["spp"]
        n_chunks = -(-n_chunks // spp_axis) * spp_axis
        backend_name = ("megakernel" if use_megakernel(meta, cfg)
                        else "wavefront") + "@" + mesh.shape_tag
        segs = make_driver_segments(scn, meta, camera, cfg, mesh,
                                    use_megakernel(meta, cfg))
        segment, fetch, finalize = segs.segment, segs.fetch, segs.finalize
        layout_tag, n_slots = segs.layout_tag, segs.n_slots
    elif use_megakernel(meta, cfg):
        backend_name = "megakernel"
        segment, layout_tag, pid = _megakernel_segments(scn, meta, camera,
                                                        cfg)
        n_slots = pid.shape[0]

        def finalize(acc):
            return mk.untile_image(acc, pid, W, H)
    else:
        backend_name = "wavefront"
        segment = _wavefront_segments(scn, meta, camera, cfg)
        layout_tag = "linear"
        n_slots = H * W

        def finalize(acc):
            return acc
    log.info("backend: %s on %s", backend_name, dev)

    ck_meta = _checkpoint_meta(cfg, backend_name, checkpoint_every,
                               layout_tag)
    writer = mesh is None or mesh.is_writer
    accum = np.zeros((n_slots, 3), dtype=np.float64)
    start_chunk = 0
    # rank 0 alone reads the checkpoint, and every rank takes its answer
    # (another host may not see the file), an error included
    loaded = None
    if resume and checkpoint_path and writer \
            and os.path.exists(checkpoint_path):
        try:
            loaded = _checkpoint_load(checkpoint_path, ck_meta)
            if loaded[0].shape[0] != n_slots:
                raise ValueError(
                    f"checkpoint {checkpoint_path} has {loaded[0].shape[0]} "
                    f"pixel slots, current layout has {n_slots}")
        except ValueError as e:
            loaded = e
    if mesh is not None and resume and checkpoint_path:
        loaded = mesh.share(loaded)
    if isinstance(loaded, ValueError):
        raise loaded
    if loaded is not None:
        accum, start_chunk = loaded
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
    # whole segments spread evenly over the spp axis
    seg_len = -(-seg_len // spp_axis) * spp_axis
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
            accum += fetch(dev_acc).astype(np.float64)
            dev_acc = None
        host_base = c
        t_flush = time.perf_counter()
        if save_ck and checkpoint_path:
            # two ranks writing one path would race on its temporary file
            if writer:
                _checkpoint_save(checkpoint_path, accum, c, ck_meta)
            if mesh is not None:
                mesh.barrier()

    # under a mesh the ranks vote, on the host, after each segment: a
    # failure on any rank rewinds every rank, and a flush (a collective)
    # is taken by all when any rank is due
    agree = (lambda *flags: flags) if mesh is None else mesh.any
    with _profiler(profile_dir if writer else None):
        while c < n_chunks:
            n = min(seg_len, n_chunks - c)
            t0 = time.perf_counter()
            failure = None
            try:
                if c <= fault_at < c + n and fault_count > 0:
                    fault_count -= 1
                    if fault_count == 0:
                        fault_at = -1
                    raise DeviceFailure(f"PT_FAULT_INJECT at chunk {c}")
                with record_function("pt.segment"):
                    out = segment(c, n)
            except DeviceFailure as exc:
                failure = exc
            if failure is None:
                with record_function("pt.accumulate"):
                    dev_acc = out if dev_acc is None else dev_acc + out
                if dev.type == "cuda":
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(dev))
                    if prev_done is not None:
                        prev_done.synchronize()
                    prev_done = done
            failed, late = agree(failure is not None,
                                 time.perf_counter() - t_flush > flush_s)
            if failed:
                failure = failure or DeviceFailure(
                    f"another rank failed at chunk {c}")
                if failures >= max_retries:
                    raise failure
                failures += 1
                stats.recoveries += 1
                log.warning(
                    "device failure at chunk %d (%s); re-rendering %d chunk(s) "
                    "from %d (retry %d/%d)", c, failure, c + n - host_base,
                    host_base, failures, max_retries)
                # the device-resident partial is dropped with the failure
                dev_acc = None
                c = host_base
                continue
            failures = 0
            c += n
            stats.samples += W * H * n * spp_chunk
            stats.segments += 1
            log.info("%d/%d chunks queued, previous segment done, in %.3fs",
                     c, n_chunks, time.perf_counter() - t0)
            if checkpoint_path and checkpoint_every > 0:
                flush(save_ck=True)
            elif late:
                flush(save_ck=False)
        flush(save_ck=checkpoint_path is not None)

    stats.wall_s = time.perf_counter() - t_total
    total_spp = n_chunks * spp_chunk
    accum = finalize(accum)
    img = (accum / float(total_spp)).astype(np.float32).reshape(H, W, 3)
    return img, stats


def _megakernel_segments(scn: SceneArrays, meta: SceneMeta, camera: Camera,
                         cfg: RenderConfig):
    """(segment(c0, n) -> [slots, 3] radiance sums on the device, the
    checkpoint layout tag, the slot -> pixel map) of the megakernel."""
    spp_chunk = cfg.samples_per_pass
    run = mk.image_launch(scn, meta, camera, spp_chunk, scn.color.device)

    def segment(c0: int, n: int) -> torch.Tensor:
        # independent random stream per segment, derived from (seed, c0);
        # the second slot is the global sample base, so segmented DoF
        # covers the whole sunflower spiral
        seed = (cfg.seed * 7919 + int(c0) + 1, int(c0) * spp_chunk)
        r, g, b = mk.trace_tiles(
            seed, *run.tables, meta=meta, cfg=cfg, spp=int(n) * spp_chunk,
            total_samples=cfg.samples, **run.kwargs)
        with record_function("pt.accumulate"):
            return torch.stack([r.reshape(-1), g.reshape(-1),
                                b.reshape(-1)], dim=-1)
    return segment, run.layout_tag, run.pid


def _wavefront_segments(scn: SceneArrays, meta: SceneMeta, camera: Camera,
                        cfg: RenderConfig):
    """segment(c0, n) -> [H*W, 3] radiance sums on the device of the
    wavefront integrator, in row blocks of cfg.rows_per_pass (the whole
    image by default), as pathtracer_tpu.driver's segment_wavefront. The
    nearest hits take the route of integrator.intersect_route, with the
    intersect kernel's tables built here once."""
    from .render import integrator, threefry

    W, H = camera.width, camera.height
    dev = scn.color.device
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    cam = camera.pack(dtype, dev)
    key = threefry.prng_key(cfg.seed)
    route = integrator.intersect_route(scn, meta, cfg)
    log.info("wavefront nearest hits: %s",
             "the intersect kernel" if route.fn else "the torch walk")

    block = cfg.rows_per_pass or H
    pad_rows = (-H) % block
    pxb, pyb = (a.reshape(-1, block * W) for a in integrator.pixel_grid(
        W, 0, H + pad_rows, dev, last_row=H - 1))

    def segment(c0: int, n: int) -> torch.Tensor:
        # one key a row block: reusing one key across blocks would repeat
        # the random stream block to block
        outs = [integrator.render_chunks(
                    scn, meta, cfg, cam, pxb[b], pyb[b], c0, n,
                    threefry.fold_in(key, 1000003 + b), route)
                for b in range(pxb.shape[0])]
        with record_function("pt.accumulate"):
            return torch.cat([o.to_array() for o in outs])[:H * W]
    return segment
