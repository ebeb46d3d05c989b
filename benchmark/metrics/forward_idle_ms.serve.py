"""Idle device ms a request of the serving window under the eager
forward's span, "request_forward": the host launching the model's
operations (`harness.spans`). Nothing where the program records no
spans."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "requests", under=("request_forward",))
