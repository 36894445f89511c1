"""Command-line entry point: `python -m pathtracer_tpu_torch`.

The flags of pathtracer_tpu.cli (reference CLI, cmd/pt/main.go:45-112, with
PT_<FLAG> environment overrides). It renders on the CUDA device
--device-index and exits with an error when there is no card; it never
falls back to the CPU, which only `--device cpu` selects (the plain
PyTorch versions of the kernels, at small sizes).

Several ranks (parallel/): PT_COORDINATOR=host:port with
PT_NUM_PROCESSES and PT_PROCESS_ID, or torchrun's environment, joins a
torch.distributed group before any use of the card (PT_DIST_BACKEND, else
nccl on the card and gloo with --device cpu); each rank renders on
cuda:(local rank % device count). --mesh PxS shards the render over a
(pixels, spp) mesh of P*S ranks, --distributed over mesh_shape_for(world
size); rank 0 alone writes the image and the metrics.

Outputs match the reference render driver: `experiment.raw` (big-endian
float32 RGB dump) and `out-<spp>-<W>x<H>.png`.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time


def _env(name: str, default, cast):
    v = os.environ.get(f"PT_{name.upper().replace('-', '_')}")
    return cast(v) if v is not None else default


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pathtracer_tpu_torch",
        description="Monte-Carlo path tracer, PyTorch + CUDA",
    )
    # reference flags (cmd/pt/main.go:48-56)
    p.add_argument("--width", type=int, default=_env("width", 1280, int))
    p.add_argument("--height", type=int, default=_env("height", 960, int))
    p.add_argument("--samples", type=int, default=_env("samples", 1, int))
    p.add_argument("--aperture", type=float,
                   default=_env("aperture", 0.0, float))
    p.add_argument("--focal-length", type=float,
                   default=_env("focal_length", 0.0, float))
    p.add_argument("--scene", type=str,
                   default=_env("scene", "reference", str))
    p.add_argument("--device-index", type=int,
                   default=_env("device_index", 0, int))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the card, the default) or cpu (the plain "
                        "versions of the kernels)")
    p.add_argument("--list-devices", action="store_true")
    p.add_argument("--list-scenes", action="store_true")
    # the JAX package's flags
    p.add_argument("--dtype", choices=("float32", "float64"),
                   default=_env("dtype", "float32", str))
    p.add_argument("--backend", choices=("auto", "pallas", "wavefront"),
                   default=_env("backend", "auto", str),
                   help="pallas = the CUDA megakernel; wavefront = the "
                        "wavefront integrator (torch ops, the intersect "
                        "kernel in f32); auto = the megakernel unless "
                        "--dtype float64 or --debug-ray")
    p.add_argument("--samples-per-pass", type=int,
                   default=_env("samples_per_pass", 8, int))
    p.add_argument("--rows-per-pass", type=int,
                   default=_env("rows_per_pass", 0, int),
                   help="wavefront memory chunking (the megakernel "
                        "ignores it)")
    p.add_argument("--seed", type=int, default=_env("seed", 0, int))
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation: one shadow ray per light "
                        "at each bounce")
    p.add_argument("--debug-ray", type=int, default=-1,
                   help="print per-bounce state for this ray index "
                        "(the wavefront backend)")
    p.add_argument("--distributed", action="store_true",
                   help="shard the render over every rank of the process "
                        "group (mesh_shape_for(world size))")
    p.add_argument("--mesh", type=str, default=None,
                   help="rank mesh PIXELSxSPP; its product must be the "
                        "world size")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint file (.npz) for save/resume")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint every N sample chunks")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the frame, "
                        "from its layout to its untile, to this directory")
    p.add_argument("--metrics-json", type=str, default=None,
                   help="write render metrics as one JSON line to this file")
    p.add_argument("--output", type=str, default=None,
                   help="PNG path (default out-<spp>-<W>x<H>.png)")
    p.add_argument("--raw-output", type=str, default="experiment.raw")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def list_devices() -> None:
    """Equivalent of cmd/pt/main.go:98-112, for CUDA devices."""
    import torch

    for i in range(torch.cuda.device_count()):
        print(f"Index: {i}")
        print("Type: GPU")
        print(f"Name: {torch.cuda.get_device_name(i)}")


def _join_group(device_type: str):
    """Join the process group named by PT_COORDINATOR (with
    PT_NUM_PROCESSES and PT_PROCESS_ID) or by torchrun's RANK and
    WORLD_SIZE; returns this rank's device, or None when neither is set."""
    from .parallel.multihost import initialize_multihost

    if os.environ.get("PT_COORDINATOR"):
        return initialize_multihost(
            os.environ["PT_COORDINATOR"],
            int(os.environ.get("PT_NUM_PROCESSES", "1")),
            int(os.environ.get("PT_PROCESS_ID", "0")),
            device_type=device_type)
    if os.environ.get("RANK") is not None \
            and os.environ.get("WORLD_SIZE") is not None:
        return initialize_multihost(device_type=device_type)
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
    )
    log = logging.getLogger("pathtracer_tpu_torch")

    from .scenes import list_scenes as _scenes

    if args.list_scenes:
        print("Available scenes:")
        for name in _scenes():
            print(f"  {name}")
        return 0
    if args.list_devices:
        list_devices()
        return 0

    import torch.distributed as dist

    from .parallel.mesh import parse_mesh

    shape = None
    if args.mesh:
        try:
            shape = parse_mesh(args.mesh)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    # the group is joined before any other use of the card
    try:
        rank_device = _join_group(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        return _run(args, log, shape, rank_device)
    finally:
        if rank_device is not None and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, log, shape, rank_device) -> int:
    """main() after the group is joined: the mesh, the device, the render
    and (rank 0 alone) its files."""
    import torch
    import torch.distributed as dist

    from .parallel.multihost import global_render_mesh

    mesh = None
    if args.mesh or args.distributed:
        try:
            mesh = global_render_mesh(shape)
        except ValueError as e:
            print(f"error: --mesh: {e}", file=sys.stderr)
            return 2
    writer = not dist.is_initialized() or dist.get_rank() == 0

    if rank_device is not None:
        device = rank_device
    elif args.device == "cpu":
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        print("error: no CUDA device; this renderer runs on the card "
              "(--device cpu runs the plain versions)", file=sys.stderr)
        return 1
    elif not 0 <= args.device_index < torch.cuda.device_count():
        print(f"error: --device-index {args.device_index} out of range "
              f"(found {torch.cuda.device_count()} CUDA devices)",
              file=sys.stderr)
        return 2
    else:
        device = torch.device(f"cuda:{args.device_index}")
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")

    from .config import RenderConfig
    from .driver import render_driver
    from .io.png import write_png
    from .io.raw import write_raw
    from .scenes import get_scene

    if args.output and writer:
        if os.path.isdir(args.output) or args.output.endswith(os.sep):
            print(f"error: --output {args.output!r} is a directory; "
                  "pass a .png file path", file=sys.stderr)
            return 2
        ext = os.path.splitext(args.output)[1].lower()
        if ext != ".png":
            print(f"error: --output {args.output!r} has unsupported "
                  f"extension {ext or '(none)'}; use .png", file=sys.stderr)
            return 2

    cfg = RenderConfig(
        width=args.width, height=args.height, samples=args.samples,
        aperture=args.aperture, focal_length=args.focal_length,
        dtype=args.dtype, samples_per_pass=args.samples_per_pass,
        rows_per_pass=args.rows_per_pass, seed=args.seed,
        backend=args.backend, nee=args.nee, debug_ray=args.debug_ray,
    )

    t0 = time.perf_counter()
    try:
        sc = get_scene(args.scene, cfg)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    arrays, meta = sc.pack(device=device, dtype=getattr(torch, args.dtype))
    log.info("scene %s: %d objects on %s (%s)", args.scene, meta.n_objects,
             device, device_name)
    extra = {}
    if mesh is not None:
        from .parallel.mesh import COLLECTIVE_S, reset_collective_time

        log.info("mesh %s: rank %d at (pixels %d, spp %d)", mesh.shape_tag,
                 mesh.rank, mesh.pix_rank, mesh.spp_rank)
        reset_collective_time()

    img, stats = render_driver(
        arrays, meta, sc.camera, cfg,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        profile_dir=args.profile,
        mesh=mesh,
    )

    dt = time.perf_counter() - t0
    log.info("render took %.2fs (%.2f Msamples/s)", dt,
             stats.msamples_per_sec)
    if mesh is not None:
        extra = dict(mesh=mesh.shape_tag, world_size=mesh.size,
                     all_reduce_s=round(COLLECTIVE_S["all_reduce"], 6),
                     all_gather_s=round(COLLECTIVE_S["all_gather"], 6),
                     host_vote_s=round(COLLECTIVE_S["host"], 6))
        log.info("collectives: all_reduce %.4fs, all_gather %.4fs, host "
                 "votes %.4fs", extra["all_reduce_s"], extra["all_gather_s"],
                 extra["host_vote_s"])
    if not writer:
        return 0
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            f.write(stats.to_json(
                scene=args.scene, width=cfg.width, height=cfg.height,
                spp=cfg.samples, total_wall_s=round(dt, 3),
                device=device_name, **extra,
            ) + "\n")

    write_raw(args.raw_output, img)
    out = args.output or f"out-{cfg.samples}-{cfg.width}x{cfg.height}.png"
    write_png(out, img)
    log.info("wrote %s and %s", args.raw_output, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
