"""Idle device ms an `evaluate_seg` call of the eval window under
"eval_metrics": the numpy loss, mIoU and accuracy on the host
(`harness.spans`). Nothing where the program records no spans."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "calls", under=("eval_metrics",))
