"""The traced window: `torch.profiler` over the window, the benchmark's own
host spans ("bench/<name>" ranges around its calls into the program),
and the reading of the device's activity from the profiler's events.

`Trace(on=False)` costs nothing: its spans are empty contexts. With
`on=True` the window runs under the profiler (CPU and CUDA activity) and
`read()` returns a `Reading`: the device operations inside the window,
its length, the seconds in which some operation ran on the device (the
union of their intervals) and the breakdown the result line carries.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field

import torch

# The port's kernels (csrc/*.cu) by the names the profiler reports.
PORT_KERNELS = {
    "K1": ("knn_kernel",),
    "K2-fwd": ("edge_moments_kernel",),
    "K2-bwd": ("edge_moments_bwd_kernel", "edge_in_degree_kernel"),
    "K3": ("knn_moments_kernel",),
    "K4": ("fps_kernel", "fps_wide_kernel"),
}
_PORT_RE = {k: re.compile(r"\b(" + "|".join(v) + r")\b")
            for k, v in PORT_KERNELS.items()}
_GEMM_RE = re.compile(r"gemm|cutlass|xmma|cublas|splitKreduce", re.I)


def port_kernel(name: str) -> str | None:
    """The port's kernel ("K1", ...) that a device operation is, or None."""
    for k, rx in _PORT_RE.items():
        if rx.search(name):
            return k
    return None


def is_gemm(name: str) -> bool:
    """Whether a device operation is a matmul kernel (cuBLAS, CUTLASS)."""
    return bool(_GEMM_RE.search(name))


@dataclass
class Reading:
    ops: list = field(default_factory=list)  # (name, start_ns, dur_ns)
    window_s: float = 0.0
    busy_s: float = 0.0
    breakdown: dict = field(default_factory=dict)

    def seconds(self, pick) -> float:
        """Device seconds of the operations whose name `pick` accepts."""
        return sum(d for n, _, d in self.ops if pick(n)) / 1e9

    def count(self, pick) -> int:
        return sum(1 for n, _, _ in self.ops if pick(n))


class Trace:
    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench/{name}")

    @contextlib.contextmanager
    def window(self):
        """Profile the body (when on) as the span "bench/window"."""
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        with self.prof:
            with self.span("window"):
                yield

    def read(self) -> Reading:
        """The device's activity inside the window."""
        events = self.prof.profiler.kineto_results.events()
        spans, ops = [], []
        w0 = w1 = None
        for e in events:
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not _annotation(e) and e.duration_ns() > 0:
                    ops.append((name, e.start_ns(), e.duration_ns()))
            elif name == "bench/window":
                w0, w1 = e.start_ns(), e.start_ns() + e.duration_ns()
            elif name.startswith("bench/"):
                spans.append((name[6:], e.start_ns(),
                              e.start_ns() + e.duration_ns()))
        if w0 is None:
            raise RuntimeError("the trace holds no bench/window span")
        ops = sorted((o for o in ops if w0 <= o[1] < w1), key=lambda o: o[1])
        busy, gaps, cursor = 0, [], w0
        for _, s, d in ops:
            if s > cursor:
                gaps.append((cursor, s))
            if s + d > cursor:
                busy += s + d - max(s, cursor)
                cursor = s + d
        if cursor < w1:
            gaps.append((cursor, w1))
        reading = Reading(ops=ops, window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9)
        reading.breakdown = {"device_ops": _top_ops(ops),
                             "idle_gaps": _top_gaps(gaps, spans)}
        return reading


def _annotation(e) -> bool:
    """Whether a profiler event is a user range rather than work (the
    event's API differs between torch versions)."""
    if hasattr(e, "is_user_annotation"):
        return bool(e.is_user_annotation())
    return "annotation" in str(e.activity_type())


def _top_ops(ops, n: int = 10) -> list:
    by = {}
    for name, _, d in ops:
        key = name[:120]
        by[key] = by.get(key, 0) + d
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in top]


def _top_gaps(gaps, spans, n: int = 10) -> list:
    """Idle device seconds by the host span the gap began in (the
    innermost one; "outside spans" where none), the largest first."""
    by, stack, i = {}, [], 0
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))  # nested ranges
    for a, b in gaps:  # in time order
        while i < len(spans) and spans[i][1] <= a:
            while stack and stack[-1][2] <= spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] <= a:
            stack.pop()
        key = stack[-1][0] if stack else "outside spans"
        by[key] = by.get(key, 0) + (b - a)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in top]
