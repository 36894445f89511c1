"""device_idle_pct (device_idle_pct.render, .train, .tri, ...): the share
of the traced window in which no operation ran on the device, in %. One
reader for every cell; the metric's name after the dot says which
end-to-end metric it moves."""


def read(ctx, job):
    tl = ctx.timeline
    if tl is None:
        return None
    w = tl.window.t1 - tl.window.t0
    return 100.0 * (1.0 - tl.busy_s() / w)
