"""The program's own spans (pathtracer_tpu_torch/spans.py) in a traced
run's trace, for the per-layer metrics that read them: the host time of
the render driver's parts a frame, and the device time of the wavefront
autograd step by op group.

The trace is read again from its fixed path, build/ptbench/trace-<cell>
.json (tracing.Timeline drops the events' args, which the attribution
needs), and parsed once a file: the readers of one run share it.

How a device operation is put down to a group (`group_ms`):

1. its "correlation" leads to the runtime or driver call that launched it
   (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...);
2. on that call's thread, the innermost enclosing event that is a "pt."
   span or a backward op decides. A span gives its group. A backward op
   ("autograd::engine::evaluate_function: ...") carries "Sequence number"
   and "Fwd thread id": it gives the group of the innermost "pt." span
   around the forward op of that sequence number on the forward thread
   (the profiler's thread ids are its own; each is matched to the trace's
   thread that holds the most forward ops of its backward ops' sequence
   numbers);
3. an operation under no group's span is "rest".

Each operation counts once, in the step its device time starts in, so the
groups and the rest sum to the steps' device time.

Every reader stays silent (None) off the card, without a traced window,
where the job is of another kind, and where the trace holds none of the
spans it reads (a program older than them).
"""
from __future__ import annotations

import bisect
import json
import os
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

from ptbench import tracing

# the wavefront autograd step's op groups, by the span that holds them
GROUPS = {"pt.rng": "rng", "pt.bounce.intersect": "intersect",
          "pt.bounce.attrs": "attrs", "pt.bounce.shade": "shade"}
REST = "rest"
BACKWARD = "autograd::engine::evaluate_function:"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Span(NamedTuple):
    name: str
    t0: float     # seconds on the trace's clock
    t1: float


class Trace:
    """The parts of one Chrome trace the span readers use."""

    def __init__(self, events: list):
        self.spans: List[Span] = []      # every "pt." span
        self.steps: List[Span] = []      # the benchmark's steps
        self.device = []                 # (t0, t1, correlation)
        threads = defaultdict(list)      # thread -> (t0, t1, kind, what)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            args = e.get("args") or {}
            t0 = e["ts"] * 1e-6
            t1 = (e["ts"] + e["dur"]) * 1e-6
            thread = (e.get("pid"), e.get("tid"))
            if cat in tracing.DEVICE_CATS:
                self.device.append((t0, t1, args.get("correlation")))
            elif cat == "user_annotation" and name == tracing.STEP:
                self.steps.append(Span(name, t0, t1))
            elif cat == "user_annotation" and name.startswith("pt."):
                self.spans.append(Span(name, t0, t1))
                threads[thread].append((t0, t1, "span", name))
            elif cat in LAUNCH_CATS and "correlation" in args:
                threads[thread].append((t0, t1, "launch",
                                        args["correlation"]))
            elif cat == "cpu_op" and "Sequence number" in args:
                seq = (args["Sequence number"], args.get("Fwd thread id"))
                kind = "backward" if name.startswith(BACKWARD) else (
                    "forward" if not seq[1] else None)
                if kind:
                    threads[thread].append((t0, t1, kind, seq))
        self.spans.sort(key=lambda s: s.t0)
        self.steps.sort(key=lambda s: s.t0)
        self.device.sort()
        self._group_of = self._attribute(threads)

    def _attribute(self, threads) -> Dict[object, str]:
        """correlation -> group of each launch (steps 2 and 3 of the
        module's rule)."""
        # a context: ("span", name) or ("backward", seq, fwd tid, t0)
        launch_ctx = {}                  # correlation -> innermost context
        forward = defaultdict(list)      # (thread, seq) -> [(t0, span)]
        for thread, evs in threads.items():
            # parents before children: by start, the longer first
            evs.sort(key=lambda e: (e[0], -e[1]))
            stack = []                   # (t1, innermost span, context)
            for t0, t1, kind, what in evs:
                while stack and stack[-1][0] <= t0:
                    stack.pop()
                span, ctx = stack[-1][1:] if stack else (None, None)
                if kind == "span":
                    span = ctx = ("span", what)
                elif kind == "backward":
                    ctx = ("backward", what[0], what[1], t0)
                elif kind == "forward":
                    forward[thread, what[0]].append((t0, span))
                elif kind == "launch":
                    launch_ctx[what] = ctx
                stack.append((t1, span, ctx))
        for v in forward.values():
            v.sort(key=lambda x: x[0])
        # the profiler's forward thread ids, each to the trace's thread
        # holding the most forward ops of its backward ops' numbers
        votes = defaultdict(lambda: defaultdict(int))
        for ctx in launch_ctx.values():
            if ctx and ctx[0] == "backward":
                for thread in threads:
                    if (thread, ctx[1]) in forward:
                        votes[ctx[2]][thread] += 1
        fwd_thread = {f: max(v, key=v.get) for f, v in votes.items()}

        def group(ctx) -> str:
            if ctx is None:
                return REST
            if ctx[0] == "backward":
                ops = forward.get((fwd_thread.get(ctx[2]), ctx[1]), [])
                i = bisect.bisect_right([t for t, _ in ops], ctx[3]) - 1
                ctx = ops[i][1] if i >= 0 else None
                if ctx is None:
                    return REST
            return GROUPS.get(ctx[1], REST)

        return {c: group(ctx) for c, ctx in launch_ctx.items()}

    def group_of(self, correlation) -> str:
        """The group of the device operation launched under
        `correlation` ("rest" where no launch or group is found)."""
        return self._group_of.get(correlation, REST)

    def group_s(self) -> Optional[Dict[str, float]]:
        """{group: device seconds a step} over the traced steps, "rest"
        among them; None without steps or device operations in them."""
        if not self.steps:
            return None
        tot = dict.fromkeys(list(GROUPS.values()) + [REST], 0.0)
        starts = [s.t0 for s in self.steps]
        seen = False
        for t0, t1, corr in self.device:
            i = bisect.bisect_right(starts, t0) - 1
            if i < 0 or t0 >= self.steps[i].t1:
                continue
            tot[self.group_of(corr)] += t1 - t0
            seen = True
        n = len(self.steps)
        return {k: v / n for k, v in tot.items()} if seen else None

    def frame_s(self, name: str) -> Optional[float]:
        """Mean over the traced steps of the host seconds in the spans
        `name` that start in each; None where no such span lies in one."""
        if not self.steps or not any(s.name == name for s in self.spans):
            return None
        tot, found = 0.0, False
        for st in self.steps:
            for s in self.spans:
                if s.name == name and st.t0 <= s.t0 < st.t1:
                    tot += s.t1 - s.t0
                    found = True
        return tot / len(self.steps) if found else None


_cache: dict = {}


def load(path) -> Optional[Trace]:
    """The parsed trace at `path` (None where there is no file), parsed
    once while the file stays as it is."""
    path = str(path)
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None
    key = (path, st.st_mtime_ns, st.st_size)
    if key not in _cache:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        _cache.clear()
        _cache[key] = Trace(events)
    return _cache[key]


def on_card(ctx) -> bool:
    dev = getattr(ctx, "device", None)
    return getattr(dev, "type", None) == "cuda"


def trace_of(ctx, job, kind: str) -> Optional[Trace]:
    """The traced run's trace where the run was traced on the card and
    its job is of `kind`, else None."""
    if (getattr(ctx, "timeline", None) is None or not on_card(ctx)
            or getattr(job, "kind", None) != kind):
        return None
    name = ctx.cell.workload["name"]
    return load(Path(ctx.root) / "build" / "ptbench" / f"trace-{name}.json")


def frame_ms(ctx, job, name: str) -> Optional[float]:
    """The mean host ms a traced frame of a render job spends in the
    driver's spans `name`."""
    tr = trace_of(ctx, job, "render")
    v = tr.frame_s(name) if tr is not None else None
    return None if v is None else 1e3 * v


def group_ms(ctx, job, group: str) -> Optional[float]:
    """Device ms a traced step of a train job put down to `group` (the
    module's rule); None where the trace holds no span of any group."""
    tr = trace_of(ctx, job, "train")
    if tr is None or not any(s.name in GROUPS for s in tr.spans):
        return None
    got = tr.group_s()
    return None if got is None else 1e3 * got[group]


def pack_s(ctx, part: str) -> Optional[float]:
    """The host seconds of `part` of the program's last scene pack, on the
    card (scene.pack.pack_scene.seconds); None where the program keeps no
    such count."""
    if not on_card(ctx):
        return None
    mod = sys.modules.get("pathtracer_tpu_torch.scene.pack")
    secs = getattr(getattr(mod, "pack_scene", None), "seconds", None)
    return secs.get(part) if secs else None
