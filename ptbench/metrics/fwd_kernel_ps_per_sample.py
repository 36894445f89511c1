"""fwd_kernel_ps_per_sample: device time of the forward megakernel's
launches in the traced window over the samples of the window's frames,
in picoseconds."""

K1 = r"(?<!grad_)megakernel<"


def read(ctx, job):
    tl = ctx.timeline
    if tl is None or getattr(job, "kind", None) != "render":
        return None
    t = sum(e.t1 - e.t0 for e in tl.ops(K1))
    n = sum(s.work for s in ctx.steps)
    return 1e12 * t / n if t > 0 and n else None
