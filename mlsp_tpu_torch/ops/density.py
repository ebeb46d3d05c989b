"""Point-cardinality (density) labels (counterpart of `mlsp_tpu/ops/density.py`).

The reference counts, per point, the neighbours within a radius with a
PCL kd-tree search capped at K=100 returned points, then builds a soft
two-hot class vector over `num_cls` bins of width `pergroup`. Brute force
here: one pairwise-distance matrix, a compare and a row sum. Plain
PyTorch: the JAX package has no kernel for it.

Quirks of the reference kept:
  * counts are capped at `cap` (=100) returned neighbours;
  * PCL pads its index matrix with 0 and the reference counts entries
    != 0, so point 0 is excluded, but only when it is among the `cap`
    nearest in radius (else it was never returned).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mlsp_tpu_torch.ops.pairwise import self_sqdist


def radius_count(xyz: torch.Tensor, radius: float,
                 cap: int = 100) -> torch.Tensor:
    """Neighbours within `radius` per point of xyz [B, N, 3], self included,
    with the two quirks above: float32 [B, N]."""
    d = self_sqdist(xyz)  # [B, N, N]
    r2 = torch.tensor(radius, dtype=torch.float32, device=d.device) ** 2
    within = d <= r2
    total = within.sum(-1, dtype=torch.float32)
    # Rank point 0 among the in-radius points by those strictly closer.
    d0 = d[..., 0:1]
    closer = (within & (d < d0)).sum(-1, dtype=torch.float32)
    zero_returned = within[..., 0] & (closer < float(cap))
    count = torch.clamp_max(total, float(cap)) - zero_returned.float()
    return torch.clamp_min(count, 0.0)


def density_labels(xyz: torch.Tensor, radius: float, num_cls: int = 16,
                   pergroup: float = 2.0, shift: float = 0.0,
                   cap: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """Soft two-hot class vectors [B, N, num_cls] (summing to 1) and the
    clipped shifted counts [B, N] (the L1 target), as `cal_density`."""
    row = radius_count(xyz, radius, cap=cap) - shift
    row = torch.clamp(row, 0.0, float((num_cls - 1) * pergroup))
    lo = torch.floor(row / pergroup).long()
    hi = torch.ceil(row / pergroup).long()
    cls = 0.5 * (F.one_hot(lo, num_cls).float() + F.one_hot(hi, num_cls).float())
    return cls, row
