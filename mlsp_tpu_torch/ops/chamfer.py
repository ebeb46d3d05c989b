"""Masked Chamfer distance (counterpart of `mlsp_tpu/ops/chamfer.py`).

The reference's mask trick: points outside the deformed region get +100
added to their column, so the row minimum never picks them, and the row
terms are weighted by the mask, so only deformed points count. Points are
[B, N, 3], masks [B, N].
"""

from __future__ import annotations

import torch

from mlsp_tpu_torch.ops.pairwise import pairwise_sqdist

_BIG = 100.0


def masked_chamfer(p1: torch.Tensor, p2: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """One-directional masked Chamfer term: the batch sum of each cloud's
    masked mean over p1 of its squared distance to the nearest masked p2.

    `amin` shares the gradient among tied minima, as `jnp.min` does
    (`min(dim)` would send it all to one).
    """
    d = pairwise_sqdist(p1, p2) + (1.0 - mask)[:, None, :] * _BIG
    mind = d.amin(-1)
    # A cloud with an empty mask would divide 0/0 in the reference; it
    # contributes 0 here, as in the JAX package.
    denom = torch.clamp_min(mask.sum(-1), 1.0)
    return ((mind * mask).sum(-1) / denom).sum()


def reconstruction_loss(pred: torch.Tensor, gold: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Symmetric masked Chamfer, averaged over the batch."""
    return (masked_chamfer(gold, pred, mask)
            + masked_chamfer(pred, gold, mask)) / pred.shape[0]
