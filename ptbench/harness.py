"""One run of one benchmark cell: set-up, a measured window, the check of
what the window produced against the plain reference, one result line.

    python -m ptbench --workload NAME --seed N --seconds S --trace 0|1

Everything a cell is made of is found by name from BENCHMARK.json, at the
root of the checkout the command runs from, and under ptbench/ there: the
configuration's file (`configs[].file`), the traffic mix
`ptbench/traffic/<traffic>.json`, whose "job" names the module
`ptbench/jobs/<job>.py` that drives the program, the cell's check limits
`ptbench/checks/<workload>.json`, and one reader
`ptbench/metrics/<metric>.py` for each metric, or, where there is none,
the reader of the part of its name before the first dot (so
`device_idle_pct.train` and `device_idle_pct.render` share
`device_idle_pct.py`). A later cell on an existing job is data alone.

The program under test is `pathtracer_tpu_torch`, on the card. The run
refuses (exit code 2, no result) without CUDA or with fewer cards than the
cell asks for, and (exit code 3) if JAX or the JAX package is loaded once
the window has closed.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from ptbench import tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "pathtracer_tpu")


class Refused(Exception):
    """A run that prints no result: its message goes to standard error."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="ptbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_module(path: Path, name: str):
    """A module of the benchmark by its file (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(here: Path, metric: str) -> Path:
    """The reader of `metric`: its own file, else its family's (the
    name up to the first dot)."""
    own = here / "metrics" / f"{metric}.py"
    return own if own.is_file() else here / "metrics" / (
        metric.split(".")[0] + ".py")


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def cell(root: Path, name: str) -> SimpleNamespace:
    """The cell `name` of root/BENCHMARK.json with its configuration,
    traffic, check limits and metric entries (those that list it, or list
    no cells)."""
    bench_path = root / "BENCHMARK.json"
    if not bench_path.is_file():
        raise Refused(f"no BENCHMARK.json in {root}", 2)
    bench = read_json(bench_path)
    wl = {w["name"]: w for w in bench["workloads"]}.get(name)
    if wl is None:
        raise Refused(f"no workload {name!r} in BENCHMARK.json", 2)
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]

    def listed(m):
        return name in m.get("workloads", [name])

    here = root / "ptbench"
    return SimpleNamespace(
        workload=wl, chips=wl["chips"], dir=here,
        config=read_json(root / conf["file"]),
        traffic=read_json(here / "traffic" / f"{wl['traffic']}.json"),
        checks=read_json(here / "checks" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if listed(m)],
        per_layer=[m for m in bench["per_layer"] if listed(m)])


def derived_seed(seed: int, *parts) -> int:
    """A 31-bit seed drawn from `seed` and `parts` (a frame's, a step's)."""
    h = hashlib.blake2b(repr((int(seed), *parts)).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & 0x7FFFFFFF


def clean_environment(root: Path, config: dict) -> None:
    """The program's knobs (PT_*) unset, so that a cell runs as its files
    state; PT_ASSETS at the directory of the configuration's stand-in
    model, inside the checkout."""
    for k in [k for k in os.environ if k.startswith("PT_")]:
        del os.environ[k]
    os.environ["PT_ASSETS"] = str(root / "build" / "ptbench" / "assets"
                                  / config["name"])


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def make_job(root: Path, c: SimpleNamespace, seed: int, device):
    """(context, job) of cell `c`: the job of its traffic's "job" module,
    with the run's seed and device, and where the run records its spans
    and steps."""
    job_mod = load_module(c.dir / "jobs" / f"{c.traffic['job']}.py",
                          f"ptbench_job_{c.traffic['job']}")
    ctx = SimpleNamespace(root=root, cell=c, seed=seed, device=device,
                          spans={}, steps=[], timeline=None)
    return ctx, job_mod.Job(ctx)


def run(argv, t0: float, root: Path = None, device=None, patch=None):
    """One run; returns (result dict, check lines). `device` (a
    torch.device) skips the look for a card, for the CPU tests; `patch`,
    called with the job before its set-up, lets a test break the timed
    path underneath."""
    args = parse_args(argv)
    root = Path.cwd() if root is None else root
    c = cell(root, args.workload)
    clean_environment(root, c.config)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: the benchmark measures the card", 2)
        if torch.cuda.device_count() < c.chips:
            raise Refused(f"{c.chips} cards asked for, "
                          f"{torch.cuda.device_count()} present", 2)
        device = torch.device("cuda", 0)
    cuda = device.type == "cuda"
    ctx, job = make_job(root, c, args.seed, device)
    if patch is not None:
        patch(job)

    job.setup()
    if cuda:
        torch.cuda.synchronize(device)
    ctx.setup_s = time.perf_counter() - t0

    trace_path = (str(root / "build" / "ptbench" / f"trace-{args.workload}"
                      ".json") if args.trace else None)
    from torch.profiler import record_function

    with tracing.profiled(trace_path, cuda):
        with record_function(tracing.WINDOW):
            tw0 = time.perf_counter()
            i = 0
            while time.perf_counter() - tw0 < args.seconds:
                s0 = time.perf_counter()
                with record_function(tracing.STEP):
                    work = job.step(i)
                ctx.steps.append(SimpleNamespace(
                    t0=s0, t1=time.perf_counter(), work=work))
                i += 1
            ctx.window_s = time.perf_counter() - tw0
    ctx.memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace_path:
        ctx.timeline = tracing.Timeline.load(trace_path)

    checks = job.check()
    entries = c.per_layer if args.trace else c.end_to_end
    metrics = {}
    for m in entries:
        reader = load_module(reader_path(c.dir, m["name"]),
                             f"ptbench_metric_{m['name']}")
        v = reader.read(ctx, job)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    # after the check and the readers, the last code of the run to load
    # modules: nothing of JAX may be loaded when the result is printed
    found = loaded_forbidden()
    if found:
        raise Refused("modules of JAX or the JAX package loaded: "
                      + ", ".join(found), 3)

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": c.chips, "memory_peak_bytes": int(ctx.memory_peak)}
    correct = bool(checks) and all(
        ch["limit"] is not None and ch["value"] <= ch["limit"]
        for ch in checks)
    result = {"correct": correct,
              "attempted": len(ctx.steps), "failed": job.failed,
              "metrics": metrics, "device": dev}
    if args.trace:
        tl = ctx.timeline
        dev["busy_s"] = tl.busy_s()
        dev["window_s"] = tl.window.t1 - tl.window.t0
        result["breakdown"] = {"device_ops": tl.device_ops(),
                               "idle_gaps": tl.idle_gaps()}
    result["checks"] = {ch["name"]: {"value": ch["value"],
                                     "limit": ch["limit"]} for ch in checks}
    took = sorted(s.t1 - s.t0 for s in ctx.steps)
    lines = [f"steps {len(took)}: seconds min {took[0]!r} median "
             f"{took[len(took) // 2]!r} max {took[-1]!r}"] if took else []
    lines += [f"check {ch['name']} = {ch['value']!r} (limit "
              f"{ch['limit']!r})" for ch in checks]
    return result, lines


def main(argv=None, t0: float = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    try:
        result, lines = run(sys.argv[1:] if argv is None else argv, t0)
    except Refused as e:
        print(f"ptbench: {e}", file=sys.stderr)
        return e.code
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0
