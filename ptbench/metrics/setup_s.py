"""setup_s: seconds from the process's start to the first measured step
(imports, the kernels' build or load, scene build and pack, warm-up)."""


def read(ctx, job):
    return ctx.setup_s
