"""frame_fetch_ms: the mean host ms a traced frame spends in the render
driver's "pt.fetch" spans: the device partial's copy to the host and its
float64 add. Read on the card only."""
from ptbench import spans


def read(ctx, job):
    return spans.frame_ms(ctx, job, "pt.fetch")
