"""k6_ps_per_sample: device time of the gradient megakernel's launches
(K6) in the traced window over the samples of the window's steps, in
picoseconds."""

K6 = r"grad_megakernel<"


def read(ctx, job):
    tl = ctx.timeline
    if tl is None or getattr(job, "kind", None) != "train":
        return None
    t = sum(e.t1 - e.t0 for e in tl.ops(K6))
    n = sum(s.work for s in ctx.steps)
    return 1e12 * t / n if t > 0 and n else None
