"""ad_shade_ms: the device ms a traced step of the wavefront autograd path
puts down to the "pt.bounce.shade" spans: each bounce's normals,
roulette, surface colour, NEE and resolve, and their backward
(ptbench/spans.py: by the launch's enclosing span, a backward op by its
forward op's). Read on the card only."""
from ptbench import spans


def read(ctx, job):
    return spans.group_ms(ctx, job, "shade")
