"""Command-line entry point: `python -m pathtracer_tpu_torch`.

The flags of pathtracer_tpu.cli (reference CLI, cmd/pt/main.go:45-112, with
PT_<FLAG> environment overrides). It renders on the CUDA device
--device-index and exits with an error when there is no card; it never
falls back to the CPU. Flags that need parts not ported yet exit with code
2 and name the ROADMAP item.

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
    p.add_argument("--list-devices", action="store_true")
    p.add_argument("--list-scenes", action="store_true")
    # the JAX package's flags
    p.add_argument("--dtype", choices=("float32", "float64"),
                   default=_env("dtype", "float32", str))
    p.add_argument("--backend", choices=("auto", "pallas", "wavefront"),
                   default=_env("backend", "auto", str),
                   help="auto/pallas = the CUDA megakernel; wavefront is "
                        "not ported yet")
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
                   help="per-bounce probe of one ray (not ported yet)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-device rendering (not ported yet)")
    p.add_argument("--mesh", type=str, default=None,
                   help="device mesh PIXELSxSPP (not ported yet)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint file (.npz) for save/resume")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint every N sample chunks")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile", type=str, default=None,
                   help="profiler trace directory (not ported yet)")
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


def _unported(args) -> str:
    """The message for the first flag that needs an unported part."""
    checks = (
        (args.backend == "wavefront", "--backend wavefront",
         "item 12 (wavefront integrator)"),
        (args.dtype == "float64", "--dtype float64",
         "item 12 (wavefront integrator)"),
        (args.distributed or args.mesh, "--distributed/--mesh",
         "item 13 (multi-GPU)"),
        (args.debug_ray >= 0, "--debug-ray",
         "item 12 (wavefront integrator)"),
        (args.profile, "--profile", "item 15 (bench keys and profiling)"),
    )
    for bad, flag, item in checks:
        if bad:
            return f"{flag} is not ported yet: ROADMAP queue 1, {item}"
    return ""


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

    msg = _unported(args)
    if msg:
        print(f"error: {msg}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; this renderer runs on the card only",
              file=sys.stderr)
        return 1
    if not 0 <= args.device_index < torch.cuda.device_count():
        print(f"error: --device-index {args.device_index} out of range "
              f"(found {torch.cuda.device_count()} CUDA devices)",
              file=sys.stderr)
        return 2
    device = torch.device(f"cuda:{args.device_index}")

    from .config import RenderConfig
    from .driver import render_driver
    from .io.png import write_png
    from .io.raw import write_raw
    from .scenes import get_scene

    if args.output:
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
    arrays, meta = sc.pack(device=device)
    log.info("scene %s: %d objects on %s (%s)", args.scene, meta.n_objects,
             device, torch.cuda.get_device_name(device))

    img, stats = render_driver(
        arrays, meta, sc.camera, cfg,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
    )

    dt = time.perf_counter() - t0
    log.info("render took %.2fs (%.2f Msamples/s)", dt,
             stats.msamples_per_sec)
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            f.write(stats.to_json(
                scene=args.scene, width=cfg.width, height=cfg.height,
                spp=cfg.samples, total_wall_s=round(dt, 3),
                device=torch.cuda.get_device_name(device),
            ) + "\n")

    write_raw(args.raw_output, img)
    out = args.output or f"out-{cfg.samples}-{cfg.width}x{cfg.height}.png"
    write_png(out, img)
    log.info("wrote %s and %s", args.raw_output, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
