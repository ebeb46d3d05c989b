"""Device-busy milliseconds per request of the serving window; the
request's latency less this is the host's share."""


def read(ctx):
    n = ctx.counts.get("requests", 0)
    if not n:
        return None
    return 1e3 * ctx.reading.busy_s / n
