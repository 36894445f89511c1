"""mesh_vote_ms: the mean host ms a traced frame spends, on rank 0, in the
program's span "pt.collective.host" (parallel/mesh.py): the ranks' votes
after each segment, broadcasts of host values and barriers over the gloo
group, each with its wait for the slowest rank. Read on the card only;
silent where the program has no such span."""
from ptbench import spans


def read(ctx, job):
    return spans.frame_ms(ctx, job, "pt.collective.host")
