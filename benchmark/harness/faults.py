"""Faults planted under a run, to show that `correct` comes out false:
`plant(kind, fault)` patches the port for the run of a traffic kind.

    unchanged  a train step that leaves the model as it was (the
               optimizer's update skipped)
    half       half of the batch left out, the mean taken over the rest
               (train: the step's batch; serve: a request's clouds, the
               rest answered with copies; eval: the later half of
               each batch's clouds)
    altered    an answer altered where it is produced (train: the step's
               loss, 1% up; serve: every answer's first logit, 1% up;
               eval: one cloud's logits, its classes reversed)
    some_sizes answers wrong at some batch sizes only, as a padding bug
               gives (serve: at every third size, 3, 6, ..., a minority
               of the requests, each answer's classes reversed)
"""

from __future__ import annotations

import contextlib
import functools

FAULTS = ("unchanged", "half", "altered", "some_sizes")


@contextlib.contextmanager
def patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _train(fault):
    import torch

    from mlsp_tpu_torch.train import seg_steps, steps

    if fault == "unchanged":
        return patched(torch.optim.Adam, "step",
                        lambda orig: lambda self, closure=None: None)
    stack = contextlib.ExitStack()
    for mod, name in ((steps, "pointda_step"), (seg_steps,
                                                "pointsegda_step")):
        def make(orig):
            @functools.wraps(orig)
            def step(model, opt, sx, sy, tx, *a, **k):
                if fault == "half":
                    h = sx.shape[0] // 2
                    return orig(model, opt, sx[:h], sy[:h], tx[:h], *a, **k)
                out = orig(model, opt, sx, sy, tx, *a, **k)
                m = out[0] if isinstance(out, tuple) else out
                m["total"] = m["total"] * 1.01
                return out
            return step
        stack.enter_context(patched(mod, name, make))
    return stack


def _serve(fault):
    from mlsp_tpu_torch import serving

    def make(orig):
        def predict(self, x):
            if fault == "half":
                h = max(1, x.shape[0] // 2)
                y = orig(self, x[:h])
                return y[[min(i, h - 1) for i in range(x.shape[0])]]
            y = orig(self, x)
            if fault == "altered":
                y[:, 0] *= 1.01
            elif x.shape[0] % 3 == 0:
                y = y[:, ::-1].copy()
            return y
        return predict
    return patched(serving.ServingModel, "predict", make)


def _eval(fault):
    from mlsp_tpu_torch.train import pointsegda_trainer as T

    if fault == "half":
        def make(orig):
            def batches(n, b, indices=None):
                sels, counts = orig(n, b, indices)
                return sels, [max(1, k // 2) for k in counts]
            return batches
        return patched(T, "eval_batches", make)

    def make(orig):
        def logits(*a, **k):
            out = orig(*a, **k)
            out[0, 0] = out[0, 0][..., ::-1].copy()
            return out
        return logits
    return patched(T, "eval_logits", make)


def plant(kind: str, fault: str):
    """A context that plants `fault` under a run of traffic `kind`."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    return {"train": _train, "serve": _serve, "eval_split": _eval}[kind](fault)
