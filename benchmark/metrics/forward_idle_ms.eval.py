"""Idle device ms an `evaluate_seg` call of the eval window under
`eval_logits` and its spans: the batches' indices, the scanned forward
(the eval graph's copy-in, replays and outputs) and the logits' fetch
(`harness.spans`). Nothing where the program records no spans."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "calls", under=("eval_logits",))
