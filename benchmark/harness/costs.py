"""The yardstick's peaks and kernel cost functions, frozen here so that a
change to the program cannot move them.

Peaks: one NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet, dense
rates): float32 outside the tensor cores, bf16 on them, HBM3 bandwidth.

Each cost function gives (operations, bytes) of one launch: the
operations the algorithm needs, every input byte read once and every
output byte written once. `bound` turns them into the least time of the
launch on the card.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound(flops: float, nbytes: float) -> float:
    """Least seconds of a launch: the larger of its float32 operations at
    the float32 peak and its bytes at the HBM peak."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def least_step_seconds(ops: dict) -> float:
    """Least seconds of a step's matmul operations {"f32": n, "bf16": n},
    each precision at its own peak."""
    return ops.get("f32", 0.0) / PEAK_F32_FLOPS + ops.get(
        "bf16", 0.0) / PEAK_BF16_FLOPS


def knn_cost(b: int, n: int, c: int, k: int,
             nq: int | None = None) -> tuple[float, float]:
    """K1 (kNN graph): per (query, point) pair 2C for the dot product and 4
    to form, clamp and compare the distance; x read once, the indices
    written once."""
    nq = n if nq is None else nq
    return float(b * nq * n * (2 * c + 4)), float(b * n * c * 4
                                                  + b * nq * k * 8)


def edge_cost(b: int, n: int, c: int, k: int,
              moments: bool = False) -> tuple[float, float]:
    """K2-fwd: 2 compares per gathered value (max and min), 5 with the sum
    and sum of squares; u and the indices read once, the outputs written
    once."""
    outs = 4 if moments else 2
    return (float(b * n * k * c * (5 if moments else 2)),
            float(b * n * c * 4 + b * n * k * 8 + outs * b * n * c * 4))


def edge_bwd_cost(b: int, n: int, c: int, k: int) -> tuple[float, float]:
    """K2-bwd: per edge and channel 2 compares and about 6 operations to
    form and add the contribution; u, max, min and the four cotangents
    read once, the indices once, du written once."""
    return float(8 * b * n * k * c), float(8 * b * n * c * 4 + b * n * k * 8)


def fps_cost(b: int, n: int, npoint: int = 0) -> tuple[float, float]:
    """K4: 8 operations per point and step; the cloud read once, the
    indices written once."""
    npoint = npoint or n
    return 8.0 * b * n * npoint, float(b * n * 3 * 4 + b * npoint * 8)


def knn_moments_cost(b: int, n: int, k: int) -> tuple[float, float]:
    """K3: K1's selection at C = 3 plus 12 multiply-adds per neighbour;
    x read once, the twelve sums written once."""
    return (float(b * n * n * (2 * 3 + 4) + 2 * 12 * b * n * k),
            float(b * n * 3 * 4 + b * n * 12 * 4))
