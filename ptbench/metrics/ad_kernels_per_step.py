"""ad_kernels_per_step: kernels the device ran a training step, over the
traced steps of the wavefront autograd path (its launch count, which the
step's host time follows)."""


def read(ctx, job):
    tl = ctx.timeline
    if tl is None or getattr(job, "kind", None) != "train" or not tl.steps:
        return None
    n = sum(len([e for e in tl.ops(None, s.t0, s.t1) if e.cat == "kernel"])
            for s in tl.steps)
    return n / len(tl.steps) if n else None
