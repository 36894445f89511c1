"""pack_device_s: host seconds of the scene arrays' copies to the device
in the scene's pack at set-up, the process's first touch of the card
among them (pathtracer_tpu_torch.scene.pack.pack_scene.seconds
["device"]). Read on the card only."""
from ptbench import spans


def read(ctx, job):
    return spans.pack_s(ctx, "device")
