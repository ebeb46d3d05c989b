"""Tracing and timing helpers (counterpart of `mlsp_tpu/utils/profiling.py`):
a device trace around a block, for the CLI's `--profile_dir`; the
reference's wall-time decorator `log_execution_time`
(`PointDA/trainer.py:145-157`); and `Timer`, a lap clock. Host clocks
read device work only after a synchronize: call
`torch.cuda.synchronize()` before `tick()`."""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with `torch.profiler` (CPU, and CUDA where a card
    is present) and write a Chrome trace to `{logdir}/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def log_execution_time(func):
    """Print the wall time of each call of `func` (reference parity)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        start = time.perf_counter()
        res = func(*args, **kwargs)
        print("[%s] took %.2f s" % (func.__name__, time.perf_counter() - start))
        return res

    return wrapper


class Timer:
    """Lap clock: `tick()` returns the seconds since the last tick (or the
    construction) and keeps them in `laps`."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps: list[float] = []

    def tick(self) -> float:
        now = time.perf_counter()
        lap = now - self.t
        self.t = now
        self.laps.append(lap)
        return lap
