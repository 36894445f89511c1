"""train_msamples_s (and train_msamples_s.tri, ...): the samples, forward
and backward, of every training step finished in the window, over the
window's seconds, in millions."""


def read(ctx, job):
    if getattr(job, "kind", None) != "train":
        return None
    return sum(s.work for s in ctx.steps) / ctx.window_s / 1e6
