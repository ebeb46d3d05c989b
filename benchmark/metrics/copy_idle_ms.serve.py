"""Idle device ms a request of the serving window under the request's
copies: the clouds to the card, the logits back to numpy, and the rest of
`predict` outside its forward (`harness.spans`). Nothing where the
program records no spans."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "requests", own=(
        "request", "request_copy_in", "request_copy_out"))
