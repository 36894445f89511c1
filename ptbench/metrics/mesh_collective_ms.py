"""mesh_collective_ms: the mean host ms a traced frame spends, on rank 0,
in the program's spans "pt.collective.all_reduce" and
"pt.collective.all_gather" (parallel/mesh.py): the joins of the frame's
sums over the spp and the pixels axes, each with the card's syncs before
and after it, so the transfer and the wait for the slowest rank of its
group. Read on the card only; silent where the program has no such span."""
from ptbench import spans


def read(ctx, job):
    got = [spans.frame_ms(ctx, job, name) for name in (
        "pt.collective.all_reduce", "pt.collective.all_gather")]
    got = [v for v in got if v is not None]
    return sum(got) if got else None
