"""The traced run's timeline: torch.profiler over the measured window,
exported as a Chrome trace and read back as device operations, host
events and the benchmark's own spans ("ptbench.window", "ptbench.step").

Kineto puts the device's timestamps on the host's clock, so a step's span
and the kernels that ran inside it can be matched by time.
"""
from __future__ import annotations

import contextlib
import heapq
import json
import os
import re
from typing import List, NamedTuple, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "ptbench.window"
STEP = "ptbench.step"


class Event(NamedTuple):
    name: str
    t0: float     # seconds on the trace's clock
    t1: float
    cat: str = ""


@contextlib.contextmanager
def profiled(path: Optional[str], cuda: bool):
    """torch.profiler over the block, its Chrome trace written to `path`
    on exit; nothing without a path."""
    if path is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)


def _short(name: str) -> str:
    """A kernel's name without its return type and its parameter list
    (the last parenthesized group, when the name ends with one)."""
    name = re.sub(r"^void ", "", name.strip())
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i].rstrip() or name
    return name


class Timeline:
    """Device operations, host events and the benchmark's spans of one
    trace, every time in seconds."""

    def __init__(self, events: list):
        self.device: List[Event] = []
        self.host: List[Event] = []
        self.steps: List[Event] = []
        self.window: Optional[Event] = None
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            ev = Event(e.get("name", ""), e["ts"] * 1e-6,
                       (e["ts"] + e["dur"]) * 1e-6, cat)
            if cat in DEVICE_CATS:
                self.device.append(ev._replace(name=_short(ev.name)))
            elif cat == "user_annotation" and ev.name == WINDOW:
                self.window = ev
            elif cat == "user_annotation" and ev.name == STEP:
                self.steps.append(ev)
            elif cat in HOST_CATS:
                self.host.append(ev)
        self.device.sort(key=lambda e: e.t0)
        self.steps.sort(key=lambda e: e.t0)

    @classmethod
    def load(cls, path: str) -> "Timeline":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    def ops(self, pattern: str = None, t0: float = None, t1: float = None):
        """Device operations whose name matches `pattern` (a regular
        expression) and that start in [t0, t1)."""
        rx = re.compile(pattern) if pattern else None
        return [e for e in self.device
                if (rx is None or rx.search(e.name))
                and (t0 is None or e.t0 >= t0) and (t1 is None or e.t0 < t1)]

    def busy(self, t0: float, t1: float):
        """The union of the device's operations clipped to [t0, t1), as
        sorted disjoint intervals."""
        out = []
        for e in self.device:
            a, b = max(e.t0, t0), min(e.t1, t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        w = self.window
        return sum(b - a for a, b in self.busy(w.t0, w.t1))

    def device_ops(self, top: int = 10):
        """[[name, seconds]] of the device operations that took most time
        in the window."""
        w = self.window
        tot = {}
        for e in self.device:
            d = min(e.t1, w.t1) - max(e.t0, w.t0)
            if d > 0:
                tot[e.name] = tot.get(e.name, 0.0) + d
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """[[host activity, seconds]] of the window's idle time on the
        device, each gap named after the innermost host event that covers
        its middle (a step's span where nothing inside it does)."""
        w = self.window
        busy = self.busy(w.t0, w.t1)
        edges = [w.t0] + [x for iv in busy for x in iv] + [w.t1]
        covers = sorted(self.host + self.steps, key=lambda e: e.t0)
        tot, heap, k = {}, [], 0
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            # the events open at mid, shortest first (a sweep over the
            # gaps in time order; closed events leave the heap lazily)
            while k < len(covers) and covers[k].t0 <= mid:
                e = covers[k]
                heapq.heappush(heap, (e.t1 - e.t0, e.t1, e.name))
                k += 1
            while heap and heap[0][1] <= mid:
                heapq.heappop(heap)
            name = heap[0][2] if heap else "outside a step"
            tot[name] = tot.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
