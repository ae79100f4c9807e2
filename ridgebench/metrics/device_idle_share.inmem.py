"""``device_idle_share.inmem`` (%, moves ``fit_s.inmem``): the share of the
traced fit from arrays resident on the card in which no kernel, copy or
fill ran on the card (the profiler's timeline)."""


def read(ctx):
    if ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
