"""The readings the check's limits are set from, at a cell's own size.

    python -m ptbench.calibrate --workload NAME --seeds 1,2,3 \
        --control-seeds 4,5,6 [--out FILE]

One process, one set-up. For each of --seeds, the numbers a run of that
seed compares against the reference, on what the program produced
("program": the lower readings; the job's `reading`). For each of
--control-seeds, the same numbers with the reference computed in bfloat16
put in the program's place ("control": the upper readings), and for each
of --fault-seeds with a fault planted in the reference put in the
program's place (--fault, a name the job's `reading` knows). One JSON line
a reading, to standard output and to --out.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ptbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None,
                    help="a fault planted in the reference put in the "
                         "program's place (a job's `reading`)")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from ptbench import harness

    if not torch.cuda.is_available():
        print("ptbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    root = Path.cwd()
    c = harness.cell(root, args.workload)
    harness.clean_environment(root, c.config)
    dev = torch.device("cuda", 0)
    ctx, job = harness.make_job(root, c, 0, dev)
    t = time.perf_counter()
    job.setup()
    torch.cuda.synchronize()
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        rec.update(workload=args.workload,
                   card=torch.cuda.get_device_name(dev))
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    emit({"kind": "setup", "seconds": time.perf_counter() - t})
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    faults = [int(s) for s in args.fault_seeds.split(",") if s]
    for kind, s in [("program", s) for s in seeds] + [
            ("control", s) for s in control] + [
            (f"fault {args.fault}", s) for s in faults]:
        ctx.seed = s
        t = time.perf_counter()
        if kind.startswith("fault"):
            got = job.reading(False, fault=args.fault)
        else:
            got = job.reading(kind == "control")
        emit({"kind": kind, "seed": s, **got,
              "seconds": time.perf_counter() - t})
    return 0


if __name__ == "__main__":
    sys.exit(main())
