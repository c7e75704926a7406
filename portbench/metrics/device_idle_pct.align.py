"""The device's idle share of the traced pass: 100 x (1 - the union of
the device events' intervals / the pass's wall time)."""


def read(ctx):
    t = ctx.trace
    if not t.events or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
