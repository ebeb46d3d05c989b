"""K1's share of its roofline over the eval window: the least time of the
kNN graphs of every eval forward (the split in batches of the test batch
size, the last one padded as `evaluate_seg` pads it) over K1's device
time. Nothing when the window's K1 launches are not those graphs."""

from benchmark.harness import costs
from benchmark.harness.trace import port_kernel


def read(ctx):
    calls, r, cfg = ctx.counts.get("calls", 0), ctx.reading, ctx.cfg
    B = cfg["test_batch_size"]
    batches = -(-ctx.cell.traffic["clouds"] // B)
    graphs = ctx.cell.ref.knn_graphs(cfg, B)

    def k1(name):
        return port_kernel(name) == "K1"

    if not calls or r.count(k1) != calls * batches * len(graphs):
        return None
    k = cfg["k"]
    least = calls * batches * sum(costs.bound(*costs.knn_cost(b, n, c, k))
                                  for b, n, c in graphs)
    return 100.0 * least / r.seconds(k1)
