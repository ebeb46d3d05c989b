"""The port's tracing (counterpart of `mlsp_tpu/utils/profiling.py`): a
device trace around a block, for the CLI's `--profile_dir`, and the span
recorder that the trainers, the step graphs, eval and serving open at
their host boundaries.

`span(name)` is on exactly when a `torch.profiler` runs (the CLI's
`--profile_dir`, a benchmark's traced window): it then opens the
profiler range "mlsp/{name}", which a Chrome trace shows beside the
kernels, and appends one record `(name, start_ns, end_ns, parent)` to
an in-memory list that `spans()` returns. `start_ns` and `end_ns` are
`time.time_ns()`, read just before the range opens and just after it
closes: the profiler's events carry Unix-epoch nanoseconds too, so spans
and device operations share one time axis. `parent` is the index of the
enclosing span's record (None at the top). Without a profiler `span`
returns one shared null context: no clock is read, nothing is recorded,
and the program computes what it computes traced. No span synchronizes,
reads a tensor or opens inside a graph capture. Spans nest on the thread
that opens them (the program's boundaries all run on the main thread).
The list holds at most `MAX_SPANS` records; spans beyond them are
counted (`dropped()`) and not kept.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 1_000_000
_NULL = contextlib.nullcontext()
_records: list = []   # [name, start_ns, end_ns, parent]
_open: list = []      # indices of the open spans' records, innermost last
_dropped = 0


class _Span:
    """One open span (see the module docstring)."""

    __slots__ = ("name", "record", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _dropped
        start = time.time_ns()
        self.range = torch.profiler.record_function(f"mlsp/{self.name}")
        self.range.__enter__()
        parent = _open[-1] if _open else None
        if len(_records) < MAX_SPANS:
            self.record = [self.name, start, None, parent]
            _open.append(len(_records))
            _records.append(self.record)
        else:  # not kept: its children hang on its parent
            self.record = None
            _open.append(parent)
            _dropped += 1
        return self

    def __exit__(self, *exc):
        _open.pop()
        self.range.__exit__(*exc)
        if self.record is not None:
            self.record[2] = time.time_ns()
        return False


def span(name: str):
    """A context manager around a host boundary of the program (see the
    module docstring): the shared null context when no profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def spans() -> list[tuple]:
    """The records so far, in the order the spans opened: `(name,
    start_ns, end_ns, parent)`, end_ns None while a span is open."""
    return [tuple(r) for r in _records]


def dropped() -> int:
    """Spans opened beyond `MAX_SPANS` records, and not kept."""
    return _dropped


def clear_spans() -> None:
    """Empty the records and the count of dropped spans (between traced
    runs, with no span open)."""
    global _dropped
    _records.clear()
    _dropped = 0


def trace_path(logdir: str) -> str:
    """`{logdir}/trace.json`, or `{logdir}/trace.rank{R}.json` for rank R
    of an initialised `torch.distributed` world, so that the ranks of a
    data-parallel run do not write over each other."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return os.path.join(logdir, f"trace.rank{dist.get_rank()}.json")
    return os.path.join(logdir, "trace.json")


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with `torch.profiler` (CPU, and CUDA where a card
    is present) and write a Chrome trace to `trace_path(logdir)`; the
    block's spans record meanwhile."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(trace_path(logdir))
