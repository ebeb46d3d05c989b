"""K1's share of its roofline over the train window: the least time of
every kNN graph of the window's steps (`costs.knn_cost` at the
configuration's graph shapes, `bound`) over K1's device time. Nothing
when the window's K1 launches are not the configuration's graphs."""

from benchmark.harness import costs
from benchmark.harness.trace import port_kernel


def read(ctx):
    steps, r = ctx.counts.get("steps", 0), ctx.reading
    graphs = ctx.cell.ref.train_knn_graphs(ctx.cfg)

    def k1(name):
        return port_kernel(name) == "K1"

    if not steps or not graphs or r.count(k1) != steps * len(graphs):
        return None
    k = ctx.cfg["k"]
    least = steps * sum(costs.bound(*costs.knn_cost(b, n, c, k))
                        for b, n, c in graphs)
    return 100.0 * least / r.seconds(k1)
