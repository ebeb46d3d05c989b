"""Share of the traced eval window in which no operation ran on the
device (the union of the device operations' intervals)."""


def read(ctx):
    r = ctx.reading
    if r.window_s <= 0:
        return None
    return 100.0 * (r.window_s - r.busy_s) / r.window_s
