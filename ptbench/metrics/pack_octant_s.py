"""pack_octant_s: host seconds of the octant node copies in the scene's
pack at set-up (pathtracer_tpu_torch.scene.pack.pack_scene.seconds
["octant"]). Read on the card only."""
from ptbench import spans


def read(ctx, job):
    return spans.pack_s(ctx, "octant")
