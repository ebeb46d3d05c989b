"""Ball query and local grouping (counterpart of `mlsp_tpu/ops/grouping.py`).

PointNet++-style set abstraction: for each sampled centroid, the first
`nsample` point indices within `radius`, short balls padded with their
first hit, an empty ball taking index 0; then the neighbourhoods gathered
and centred. Plain PyTorch on any device: the JAX package runs both on
XLA, with no Pallas kernel. Under an active points mesh the ball query
splits the centers over the points group (`parallel.split_points`).
"""

from __future__ import annotations

import torch

from mlsp_tpu_torch.ops.knn import knn_gather
from mlsp_tpu_torch.ops.pairwise import pairwise_sqdist
from mlsp_tpu_torch.parallel.mesh import split_points


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """First `nsample` point indices within `radius` of each center.

    The in-ball test is d <= r² on `pairwise_sqdist` (‖c‖² − 2c·x + ‖x‖²,
    clamped at 0: the JAX formula) with r² squared in float32. A point
    within rounding of the radius can fall on either side of it in the two
    packages.

    Args:
      xyz: [B, N, 3] points.
      centers: [B, S, 3] query centroids.
      radius: ball radius.
      nsample: neighbours per ball (<= N).

    Returns:
      int64 [B, S, nsample]: in-ball indices in ascending order; balls
      with fewer hits repeat their first hit, empty balls take index 0.
    """
    N = xyz.shape[1]
    if not 1 <= nsample <= N:
        raise ValueError(f"ball_query: nsample={nsample} outside [1, {N}]")
    return split_points(lambda c: _ball_rows(xyz, c, radius, nsample),
                        centers)


def _ball_rows(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """`ball_query` of the given centers [B, M, 3]."""
    N = xyz.shape[1]
    d = pairwise_sqdist(centers, xyz)  # [B, M, N]
    # a fill, not a host copy: a step graph captures it
    r2 = torch.full((), radius, dtype=torch.float32, device=d.device) ** 2
    ranks = torch.arange(N, device=d.device).expand_as(d)
    keyed = torch.where(d <= r2, ranks, N)  # out-of-ball points sort last
    idx = torch.topk(keyed, nsample, dim=-1, largest=False,
                     sorted=True).values
    first = idx[..., :1]
    first = torch.where(first >= N, 0, first)
    return torch.where(idx >= N, first, idx)


def group_points(xyz: torch.Tensor, feats: torch.Tensor | None,
                 centers: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gathered neighbourhoods, centred: xyz [B, N, 3], optional feats
    [B, N, C], centers [B, S, 3], idx [B, S, K] -> [B, S, K, 3(+C)], the
    local coordinates (xyz - center) with the point features appended."""
    g_xyz = knn_gather(xyz, idx) - centers[:, :, None, :]
    if feats is None:
        return g_xyz
    return torch.cat([g_xyz, knn_gather(feats, idx)], dim=-1)
