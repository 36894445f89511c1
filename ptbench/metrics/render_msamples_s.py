"""render_msamples_s: the samples of every frame finished in the window,
over the window's seconds, in millions."""


def read(ctx, job):
    if getattr(job, "kind", None) != "render":
        return None
    return sum(s.work for s in ctx.steps) / ctx.window_s / 1e6
