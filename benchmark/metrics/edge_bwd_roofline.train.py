"""K2-bwd's share of its roofline over the train window: the least time of
every EdgeConv backward of the window's steps (`costs.edge_bwd_cost` at
the layers' output shapes) over K2-bwd's device time, its in-degree
pre-pass included. Nothing when the window's K2-bwd launches are not the
configuration's layers."""

from benchmark.harness import costs
from benchmark.harness.trace import port_kernel


def read(ctx):
    steps, r = ctx.counts.get("steps", 0), ctx.reading
    layers = ctx.cell.ref.train_edge_backwards(ctx.cfg)
    main = r.count(lambda n: "edge_moments_bwd_kernel" in n)
    if not steps or not layers or main != steps * len(layers):
        return None
    k = ctx.cfg["k"]
    least = steps * sum(costs.bound(*costs.edge_bwd_cost(b, n, c, k))
                        for b, n, c in layers)
    return 100.0 * least / r.seconds(lambda n: port_kernel(n) == "K2-bwd")
