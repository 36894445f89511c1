"""frame_layout_ms: the mean host ms a traced frame spends in the render
driver's "pt.layout" span: the segments' set-up (the slot layout, the
tables and their copies to the device). Read on the card only."""
from ptbench import spans


def read(ctx, job):
    return spans.frame_ms(ctx, job, "pt.layout")
