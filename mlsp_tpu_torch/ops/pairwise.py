"""Pairwise squared distances (counterpart of `mlsp_tpu/ops/pairwise.py`).

Plain PyTorch: the kNN kernel's reference version builds its graph from
this, and the tests hold both against the JAX package.
"""

from __future__ import annotations

import torch


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances between two point sets.

    Args:
      x: [..., N, C] points.
      y: [..., M, C] points.

    Returns:
      [..., N, M] float32 squared distances ``‖x‖² − 2x·y + ‖y‖²``,
      clamped at 0 (the matmul form can go slightly negative in float32).
    """
    x = x.float()
    y = y.float()
    # A true float32 product: kNN order is consumed downstream, and TF32
    # (about three decimal digits) would reorder near ties. Matmuls on
    # the card run in float32 unless `torch.backends.cuda.matmul.allow_tf32`
    # is switched on, which the port never does.
    inner = torch.matmul(x, y.transpose(-1, -2))
    xx = x.square().sum(-1, keepdim=True)
    yy = y.square().sum(-1, keepdim=True)
    d = xx - 2.0 * inner + yy.transpose(-1, -2)
    return d.clamp_min(0.0)


def self_sqdist(x: torch.Tensor) -> torch.Tensor:
    """Squared distances of a point set against itself: [..., N, N]."""
    return pairwise_sqdist(x, x)
