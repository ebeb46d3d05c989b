"""Idle device ms a step of the train window under `run_chunk` and its
spans: a capture, the copy into the step graph's inputs, the replays'
enqueue, the outputs' copy, the scheduler, eager steps
(`harness.spans`). Nothing where the program records no spans."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "steps", under=("run_chunk",))
