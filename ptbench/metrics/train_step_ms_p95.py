"""train_step_ms_p95: the 95th percentile of the wall times of every
training step in the window, from its start to its loss on the host, in
ms (Python's statistics.quantiles, 20 groups, the 19th cut)."""
import statistics


def read(ctx, job):
    if getattr(job, "kind", None) != "train" or len(ctx.steps) < 2:
        return None
    took = [1e3 * (s.t1 - s.t0) for s in ctx.steps]
    return statistics.quantiles(took, n=20)[18]
