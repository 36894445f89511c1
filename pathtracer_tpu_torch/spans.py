"""Named spans of the program's host work, on the profiler's clock.

`span(name)` is a context manager: while a torch profiler runs it is
`torch.profiler.record_function(name)`, so the span lands in the trace
beside the device's kernels (Kineto puts their timestamps on the host's
clock); otherwise it is one shared null context, and entering it costs a
flag check. There is no switch of its own: the spans are live exactly
when a profiler is (the CLI's --profile, the benchmark's --trace 1).

The spans, by layer:

- render driver (driver.py), each frame: "pt.layout" (the segments'
  set-up: the slot layout, the tables and their copies to the device),
  "pt.segment" (a launch's enqueue) with "pt.stack" inside it (the
  hand-over of its sums), "pt.accumulate" (the add onto the device
  partial), "pt.wait" (the host blocked on a segment's event); on the host
  finish "pt.fetch" (the partial's copy to the host and its float64 add)
  and "pt.untile" (the slots back to pixels and the scale to the image),
  on the device finish "pt.untile" (the finish kernel and its sync) and
  "pt.fetch" (the image's copy to the host);
- wavefront autograd (diff/grad.py, render/integrator.py): "pt.ad.forward"
  (image_loss) and "pt.ad.backward" (torch.autograd.grad); "pt.bounce" a
  bounce, in it "pt.bounce.intersect" (the nearest hit and the smooth
  normal), "pt.bounce.attrs" (the triangle-colour and object-attribute
  gathers) and "pt.bounce.shade" (normals, roulette, surface colour, NEE,
  resolve); "pt.rng" every threefry draw (render/threefry.py). A bounce
  recomputed under torch.utils.checkpoint enters its spans again inside
  "pt.ad.backward";
- gradient megakernel (render/grad.py): "pt.grad.forward" (the forward
  launch) and "pt.grad.backward" (the cotangents, the gradient launch and
  the scatter into the parameters);
- mesh collectives (parallel/mesh.py), on a RenderMesh of several ranks:
  "pt.collective.all_reduce" (the spp axis's sum) and
  "pt.collective.all_gather" (the pixels axis's gather), each with the
  card's syncs before and after it, so the wait for the slowest rank of
  the group is inside; "pt.collective.host" (a vote, a broadcast of a
  host value or a barrier over the gloo group).
"""
from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()


def span(name: str):
    """The profiler's record_function(name) while a profiler runs, else a
    null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL
