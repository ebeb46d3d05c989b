"""Device nanoseconds a vector-attention edge over the train window: the
window's device time outside the port's kernels (K1-K4: the whole step
but the kNN graphs, FPS and EdgeConv, so the edge MLPs, softmaxes and
gathers of the vector attentions, and beside them the transition MLPs,
the heads, PCM, DefRec and Adam) over the edges of the configuration's
vector attentions (`train_vector_attentions` of the reference, B N k a
call) times the window's steps. Each vector attention launches one K1
self-kNN and nothing else of the step does, so the reading is nothing
when the window's K1 launches are not one a listed attention."""

from benchmark.harness.trace import port_kernel


def read(ctx):
    steps, r = ctx.counts.get("steps", 0), ctx.reading
    listed = getattr(ctx.cell.ref, "train_vector_attentions", None)
    listed = listed(ctx.cfg) if listed else []

    def k1(name):
        return port_kernel(name) == "K1"

    if not steps or not listed or r.count(k1) != steps * len(listed):
        return None
    edges = steps * sum(b * n * k for b, n, k, _, _ in listed)
    return 1e9 * r.seconds(lambda name: port_kernel(name) is None) / edges
