"""Brute-force k-nearest-neighbour graph (counterpart of `mlsp_tpu/ops/knn.py`).

`knn_indices` runs the hand-written CUDA kernel (`ops/kernels/knn.py`) on a
CUDA tensor and its plain PyTorch version, below, on a CPU tensor. The plain
version is also what the card tests (`tests/test_torch_port_cuda.py`) and
`chip_smoke.py`'s guards hold the kernel against.
Inside `parallel.points_sharding` each rank builds the graph of its rows of
the queries (K1's query range on the card) and the rows are gathered over
the points group: the JAX package partitions the same work there through its
distance matrix, on XLA.
"""

from __future__ import annotations

import torch

from mlsp_tpu_torch.ops.kernels.knn import knn_cuda
from mlsp_tpu_torch.ops.pairwise import pairwise_sqdist
from mlsp_tpu_torch.parallel.mesh import (
    active_points_mesh,
    gather_points,
    points_rows,
    split_points,
)

BACKENDS = ("auto", "cuda", "torch")


def use_kernel(t: torch.Tensor, backend: str) -> bool:
    """Whether a kernel wrapper launches its CUDA kernel for tensor `t`.

    "auto" launches it for a CUDA tensor and takes the plain version for a
    CPU tensor; "cuda" insists on the kernel; "torch" takes the plain
    version on any device (the comparison path).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "torch":
        return False
    if t.is_cuda:
        return True
    if backend == "auto" and t.device.type == "cpu":
        return False
    raise ValueError(
        f"backend={backend!r} has no path for a tensor on {t.device}")


def knn_indices_torch(x: torch.Tensor, k: int,
                      rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Plain version of the kNN kernel: int64 [B, N, k], or with
    `rows=(q0, nq)` [B, nq, k], the graph of the queries [q0, q0 + nq)."""
    if rows is None:
        return knn_indices_cross(x, x, k)
    q0, nq = rows
    return knn_indices_cross(x[:, q0:q0 + nq], x, k)


def knn_indices_cross(x: torch.Tensor, y: torch.Tensor, k: int) -> torch.Tensor:
    """The k nearest points of `y` per point of `x`: int64 [B, N, k].

    `pairwise_sqdist` (clamped at 0), then a stable sort, which keeps equal
    distances in index order as `lax.top_k` does (`torch.topk` leaves the
    order of ties unspecified). The JAX package runs the cross-set case on
    XLA, never on its Pallas kernel, so this is its port.
    """
    d = pairwise_sqdist(x, y)
    return torch.sort(d, dim=-1, stable=True).indices[..., :k].contiguous()


def knn_indices(x: torch.Tensor, k: int, y: torch.Tensor | None = None,
                backend: str = "auto") -> torch.Tensor:
    """Indices of the k nearest points of `y` (default: `x`) per point of `x`.

    Self-matches are included, distances are clamped at 0 and ties go to
    the lower index, as in the JAX package's XLA path. The self-kNN runs
    the K1 kernel on a CUDA tensor; the cross-set kNN (`y` given) is plain
    PyTorch on any device, as JAX runs it on XLA. Under an active points
    mesh each rank builds its rows of x (the self-kNN through K1's query
    range on the card) and the graph is gathered over the points group.

    Args:
      x: [B, N, C] query points or features.
      k: number of neighbours.
      y: optional [B, M, C] database points.
      backend: "auto" | "cuda" | "torch" (see `use_kernel`).

    Returns:
      int64 [B, N, k] indices into y (or x), ready for `knn_gather`.
    """
    if x.ndim != 3 or (y is not None and (y.ndim != 3
                                          or y.shape[::2] != x.shape[::2])):
        raise ValueError(f"knn_indices: expected [B, N, C] (and [B, M, C]), "
                         f"got {tuple(x.shape)}"
                         + ("" if y is None else f", {tuple(y.shape)}"))
    m = (x if y is None else y).shape[1]
    if k > m:
        raise ValueError(f"knn_indices: k={k} exceeds the {m} database points")
    if y is not None:
        use_kernel(x, backend)  # validates the backend name and device
        return split_points(lambda q: knn_indices_cross(q, y, k), x)
    kernel = use_kernel(x, backend)
    mesh = active_points_mesh()
    if mesh is None:
        return knn_cuda(x, k) if kernel else knn_indices_torch(x, k)
    rows = points_rows(x.shape[1], mesh)
    idx = knn_cuda(x, k, rows) if kernel else knn_indices_torch(x, k, rows)
    return gather_points(idx, x.shape[1], mesh)


def knn_gather(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-neighbour features: feats [B, M, C], idx [B, N, k] -> [B, N, k, C]."""
    b = torch.arange(feats.shape[0], device=feats.device)[:, None, None]
    return feats[b, idx]


def edge_features(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """EdgeConv input features: concat(x_j - x_i, x_i) -> [B, N, k, 2C]."""
    neigh = knn_gather(feats, idx)
    center = feats[:, :, None, :].expand_as(neigh)
    return torch.cat([neigh - center, center], dim=-1)
