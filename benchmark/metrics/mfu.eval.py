"""The eval forward's share of the card's peak: the least time of the
matmul operations of every cloud the window evaluated (the
configuration's count per cloud, the padding of a split's last batch
left out) over the window's length."""

from benchmark.harness import costs


def read(ctx):
    clouds, r = ctx.counts.get("clouds", 0), ctx.reading
    if not clouds or r.window_s <= 0:
        return None
    least = costs.least_step_seconds(ctx.cell.ref.eval_cloud_ops(ctx.cfg))
    return 100.0 * clouds * least / r.window_s
