"""EdgeConv neighbourhood statistics (counterpart of
`mlsp_tpu/ops/pallas/edge_pallas.py::edge_moments`, forward only).

For graph features xg and projected features u, each point's max, min and,
on request, sum and sum of squares of u over its k nearest neighbours in
xg. The TPU kernel rebuilt the kNN selection as a mask and reduced with
mask matmuls because Mosaic has no in-kernel gather; on the card the graph
comes from the kNN kernel and a second kernel gathers the neighbour rows
(`ops/kernels/edge.py`).
"""

from __future__ import annotations

import torch

from mlsp_tpu_torch.ops.kernels.edge import edge_moments_cuda
from mlsp_tpu_torch.ops.knn import knn_gather, knn_indices, use_kernel


def edge_moments_torch(u: torch.Tensor, idx: torch.Tensor,
                       want_moments: bool) -> tuple[torch.Tensor, ...]:
    """Plain version of the statistics kernel on given neighbour indices."""
    g = knn_gather(u.float(), idx)  # [B, N, k, C]
    outs = (g.amax(-2), g.amin(-2))
    if want_moments:
        outs += (g.sum(-2), (g * g).sum(-2))
    return outs


def edge_moments(xg: torch.Tensor, u: torch.Tensor, k: int,
                 want_moments: bool = True,
                 backend: str = "auto") -> tuple[torch.Tensor, ...]:
    """kNN neighbourhood statistics of `u` over the graph of `xg`.

    Args:
      xg: [B, N, Cg] features the kNN graph is built on.
      u: [B, N, C] features to aggregate (self included, like
        `knn_indices`).
      k: neighbourhood size.
      want_moments: also return the sum and sum of squares.
      backend: "auto" | "cuda" | "torch" (see `ops.knn.use_kernel`).

    Returns:
      (mx, mn, s1, s2), each float32 [B, N, C], or (mx, mn) if not
      `want_moments`.
    """
    idx = knn_indices(xg, k, backend=backend)
    if use_kernel(u, backend):
        return edge_moments_cuda(u, idx, want_moments)
    return edge_moments_torch(u, idx, want_moments)
