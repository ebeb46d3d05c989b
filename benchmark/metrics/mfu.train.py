"""The whole train step's share of the card's peak: the least time of the
window's steps' matmul operations (the configuration's per-step count,
each precision at its own peak, `costs.least_step_seconds`) over the
window's length."""

from benchmark.harness import costs


def read(ctx):
    steps, r = ctx.counts.get("steps", 0), ctx.reading
    if not steps or r.window_s <= 0:
        return None
    least = costs.least_step_seconds(ctx.cell.ref.train_step_ops(ctx.cfg))
    return 100.0 * steps * least / r.window_s
