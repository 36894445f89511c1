"""frame_untile_ms: the mean host ms a traced frame spends in the render
driver's "pt.untile" span: the slots back to pixels (the float64
np.add.at) and the scale to the image. Read on the card only."""
from ptbench import spans


def read(ctx, job):
    return spans.frame_ms(ctx, job, "pt.untile")
