"""Per-card calibration of the EdgeConv neighbourhood statistics
(counterpart of `mlsp_tpu/utils/chipcal.py`, the `calibrate` command).

The JAX package times its two EdgeConv cores on each TPU, the XLA
gather route ("moments") against the Pallas kernel ("fused"), and lets
`edge_impl="auto"` pick the faster per layer shape. The port has one
EdgeConv core: its DGCNN always takes the statistics through K2
(`ops.edge.edge_moments`), so the record selects nothing. It is a
per-card measurement, kept in the JAX package's record layout for its
readers (`resolve_shape`, `nearest_shape_key`, the same log-space rule):
"moments_ms" is the gather route (the kNN graph, `knn_gather`, then max,
min, sum and sum of squares over k, differentiated by autograd), "fused_ms"
K2 (`EdgeMoments`: K2-fwd, and K2-bwd for the gradient), both forward and
backward with the graph from K1, so the two differ by K2 alone; "winner"
names the faster.

Timing: CUDA events around each forward + backward, the launches queued
behind a sleep on the card, median of 20 after 3 warm-ups. The records
are cached in `mlsp_tpu_torch/_build/chipcal.json`, one per shape, keyed
by `torch.cuda.get_device_name()`; `force` measures again.
"""

from __future__ import annotations

import json
import math
import os
import statistics
from pathlib import Path

import torch

_K = 20
_QUEUE_CYCLES = 50_000_000  # the sleep the timed launches queue behind

#: The measured shape grid (the JAX package's): the flagship layer, its
#: widest C, and the seg model's N.
SHAPES: dict[str, dict] = {
    "n1024_c64": dict(B=8, N=1024, C=64),
    "n1024_c256": dict(B=8, N=1024, C=256),
    "n2048_c64": dict(B=8, N=2048, C=64),
}

CACHE = Path(__file__).resolve().parents[1] / "_build" / "chipcal.json"


def _shape_dist(key: str, n: int, c: int):
    """Log-space distance of a measured shape to (n, c), ties to the larger
    measured C; an unknown key sorts last."""
    s = SHAPES.get(key)
    if s is None:
        return (float("inf"), 0)
    return (abs(math.log(s["N"] / n)) + abs(math.log(s["C"] / c)), -s["C"])


def nearest_shape_key(n: int, c: int, records=None) -> str:
    """The measured shape nearest to a layer's (n, c), over `SHAPES` or
    over the keys of `records`."""
    keys = SHAPES if records is None else records
    return min(keys, key=lambda k: _shape_dist(k, n, c))


def resolve_shape(records: dict, n: int, c: int) -> dict:
    """The record of the measured shape nearest to (n, c)."""
    return records[nearest_shape_key(n, c, records)]


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(_QUEUE_CYCLES)
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for e0, e1 in pairs:
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in pairs)


def edge_routes(shape: str = "n1024_c64",
                device: str | torch.device = "cuda") -> tuple:
    """The seeded inputs at one `SHAPES` entry and the two routes over
    them: (xg, u, cot, {"moments": fn, "fused": fn}). Each fn takes the
    four statistics (max, min, sum, sum of squares over the k = 20
    neighbours of xg) of u with the graph from K1, then du of their
    contraction with the cotangents `cot` [4, B, N, C]; it returns
    (statistics, du)."""
    from mlsp_tpu_torch.ops.edge import edge_moments, edge_moments_torch
    from mlsp_tpu_torch.ops.knn import knn_indices

    dims = SHAPES[shape]
    B, N, C = dims["B"], dims["N"], dims["C"]
    g = torch.Generator(device=device).manual_seed(0)
    xg = torch.randn(B, N, C, generator=g, device=device)
    u = torch.randn(B, N, C, generator=g, device=device, requires_grad=True)
    cot = torch.randn(4, B, N, C, generator=g, device=device)

    def route(stats):
        def step():
            s = stats()
            loss = sum((t * c).sum() for t, c in zip(s, cot))
            (du,) = torch.autograd.grad(loss, u)
            return s, du
        return step

    return xg, u, cot, {
        "moments": route(lambda: edge_moments_torch(u, knn_indices(xg, _K),
                                                    True)),
        "fused": route(lambda: edge_moments(xg, u, _K, True, backend="cuda"))}


def measure_edge_impl(shape: str = "n1024_c64",
                      device: str | torch.device = "cuda") -> dict:
    """Time the gather route and K2 on this card at one `SHAPES` entry,
    forward and backward (`edge_routes`). Returns {"moments_ms",
    "fused_ms", "winner"}."""
    routes = edge_routes(shape, device)[3]
    out = {f"{name}_ms": round(_median_ms(step), 4)
           for name, step in routes.items()}
    out["winner"] = ("fused" if out["fused_ms"] < out["moments_ms"]
                     else "moments")
    return out


def _load_cache() -> dict:
    try:
        with open(CACHE) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def edge_calibration(force: bool = False) -> dict:
    """This card's per-shape records {shape: {"moments_ms", "fused_ms",
    "winner"}}, measuring the shapes the cache lacks (all of them with
    `force`). Without a card: the records cached for no device, that is {}
    (the caller reports that calibration is unavailable)."""
    if not torch.cuda.is_available():
        return {}
    key = torch.cuda.get_device_name()
    cache = _load_cache()
    records = {} if force else dict(cache.get(key, {}))
    missing = [s for s in SHAPES if s not in records]
    if not missing:
        return records
    for shape in missing:
        records[shape] = measure_edge_impl(shape)
    cache[key] = records
    CACHE.parent.mkdir(parents=True, exist_ok=True)
    tmp = CACHE.with_suffix(f".{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=1)
    os.replace(tmp, CACHE)
    return records
