"""frame_wait_ms: the mean host ms a traced frame spends in the render
driver's "pt.wait" spans: the host blocked on a segment's event, the
frame's device-bound share. Read on the card only."""
from ptbench import spans


def read(ctx, job):
    return spans.frame_ms(ctx, job, "pt.wait")
