"""Step-graph captures in the train window (the program's "capture"
spans): 0 once set-up has captured the run's graph. Nothing where the
program records no spans."""

from benchmark.harness import spans


def read(ctx):
    return spans.count(ctx, "capture")
