"""mesh_nccl_ms: the mean device ms a traced frame spends, on rank 0's
card, in NCCL's kernels (a name holding "nccl"): the collectives' transfer
on the card, with a kernel's wait for the other ranks once it runs. Silent
without such a kernel (gloo, the CPU)."""

NCCL = r"(?i)nccl"


def read(ctx, job):
    tl = ctx.timeline
    if tl is None or getattr(job, "kind", None) != "render" or not tl.steps:
        return None
    per = [sum(e.t1 - e.t0 for e in tl.ops(NCCL, s.t0, s.t1))
           for s in tl.steps]
    if not any(per):
        return None
    return 1e3 * sum(per) / len(per)
