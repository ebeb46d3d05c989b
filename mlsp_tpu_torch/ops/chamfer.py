"""Masked Chamfer distance and nearest-index transport (counterpart of
`mlsp_tpu/ops/chamfer.py`, the reference's `MLSP/mlsp.py:115-238`).

The reference's mask trick: points outside the deformed region get +100
added to their column, so the row minimum never picks them, and the row
terms are weighted by the mask, so only deformed points count. Points are
[B, N, 3], masks [B, N]. Under an active points mesh each direction's
query rows are split over the points group (`parallel.split_points`).
"""

from __future__ import annotations

import torch

from mlsp_tpu_torch.ops.pairwise import pairwise_sqdist
from mlsp_tpu_torch.parallel.mesh import split_points

_BIG = 100.0


def _masked_sqdist(p1: torch.Tensor, p2: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """||p1_i - p2_j||² [B, N, M], the columns outside the mask pushed away
    by +100."""
    return pairwise_sqdist(p1, p2) + (1.0 - mask)[:, None, :] * _BIG


def masked_chamfer(p1: torch.Tensor, p2: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """One-directional masked Chamfer term: the batch sum of each cloud's
    masked mean over p1 of its squared distance to the nearest masked p2.

    `amin` shares the gradient among tied minima, as `jnp.min` does
    (`min(dim)` would send it all to one).
    """
    mind = split_points(lambda q, p, m: _masked_sqdist(q, p, m).amin(-1),
                        p1, p2, mask)
    # A cloud with an empty mask would divide 0/0 in the reference; it
    # contributes 0 here, as in the JAX package.
    denom = torch.clamp_min(mask.sum(-1), 1.0)
    return ((mind * mask).sum(-1) / denom).sum()


def reconstruction_loss(pred: torch.Tensor, gold: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Symmetric masked Chamfer, averaged over the batch."""
    return (masked_chamfer(gold, pred, mask)
            + masked_chamfer(pred, gold, mask)) / pred.shape[0]


def nearest_index_pair(pred: torch.Tensor, gold: torch.Tensor,
                       mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The masked nearest-neighbour index maps in both directions
    (`findindexs`, `mlsp.py:184-220`), which carry per-point normal and
    density labels between the DefRec prediction and the original cloud.
    Ties go to the lowest index, as `jnp.argmin` takes them.

    Returns (pred -> gold [B, N], gold -> pred [B, N]), int64, no
    gradient."""
    def nearest(q, p, m):
        return _masked_sqdist(q, p, m).argmin(-1)

    with torch.no_grad():
        pred, gold = pred.detach(), gold.detach()
        return (split_points(nearest, pred, gold, mask),
                split_points(nearest, gold, pred, mask))
