"""frame_gap_ms: the mean over the traced frames of a frame's wall time
less the device time of its forward-megakernel launches, in ms: the
driver's host work (tables, layout, launches, waits, stack-and-add,
fetch, untile)."""

K1 = r"(?<!grad_)megakernel<"


def read(ctx, job):
    tl = ctx.timeline
    if tl is None or getattr(job, "kind", None) != "render" or not tl.steps:
        return None
    gaps = [(s.t1 - s.t0) - sum(e.t1 - e.t0 for e in tl.ops(K1, s.t0, s.t1))
            for s in tl.steps]
    return 1e3 * sum(gaps) / len(gaps)
