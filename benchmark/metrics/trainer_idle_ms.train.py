"""Idle device ms a step of the train window under the trainer's own
spans: the epoch's batch order, a chunk's gather and its unstacking, the
fetch of the losses and of the seg step's predictions (`harness.spans`).
Nothing where the program records no spans."""

from benchmark.harness import spans

TRAINER = ("epoch_pairs", "train_epoch", "gather", "fetch_metrics",
           "fetch_preds")


def read(ctx):
    return spans.idle_ms(ctx, "steps", own=TRAINER)
