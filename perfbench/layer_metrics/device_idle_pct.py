"""Share of the traced window in which no device operation ran."""


def read(ctx):
    if ctx.reduced.window_s <= 0 or ctx.reduced.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.reduced.busy_s / ctx.reduced.window_s)
