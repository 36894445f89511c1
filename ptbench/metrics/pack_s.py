"""pack_s: host seconds of the scene's build and pack in set-up (the
scene's factory and Scene.pack: parse, normals, BVH build, octant copies,
the arrays on the device)."""


def read(ctx, job):
    return ctx.spans.get("pack")
