"""k1_roofline_pct: the forward megakernel's share of its roofline in the
traced window, in %: the least time the card could take for the window's
work (ptbench/roofline.py; the work per sample counted by the reference
over a whole 8-spp frame) over the device time of the launches. Read on
scenes without meshes only."""

K1 = r"(?<!grad_)megakernel<"


def read(ctx, job):
    tl = ctx.timeline
    if tl is None or getattr(job, "kind", None) != "render":
        return None
    t = sum(e.t1 - e.t0 for e in tl.ops(K1))
    if t <= 0:
        return None
    bound = job.forward_bound_s(sum(s.work for s in ctx.steps),
                                len(ctx.steps))
    return None if bound is None else 100.0 * bound[0] / t
