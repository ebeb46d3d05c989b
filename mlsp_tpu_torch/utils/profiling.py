"""A device trace around a block (counterpart of
`mlsp_tpu/utils/profiling.py::device_trace`), for the CLI's
`--profile_dir`."""

from __future__ import annotations

import contextlib
import os

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
