"""MLSP loss functions (counterpart of `mlsp_tpu/losses/losses.py`;
channels-last, masks [B, N]). Weights and normalisation follow the
reference; `p_vec` density predictions are post-softmax probabilities.
The Chamfer-transported losses come with the `Density_normal_viachamfer`
branch (ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mlsp_tpu_torch.ops.chamfer import reconstruction_loss

DEFREC_SCALER = 20.0  # MLSP/mlsp.py:7
_KL_EPS = 1e-10
_L1_LAMBDA = 0.05  # mlsp.py:431 lambda_1
_KL_LAMBDA = 1.0  # mlsp.py:432 lambda_2


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels."""
    return F.cross_entropy(logits.float(), labels.long())


def defrec_loss(pred, gold, mask, defrec_weight: float) -> torch.Tensor:
    """`mlsp.calc_loss` (mlsp.py:222-229)."""
    return defrec_weight * reconstruction_loss(pred, gold, mask) * DEFREC_SCALER


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-12)


def normal_loss(pred, gt, weight: float) -> torch.Tensor:
    """`mlsp.calc_normal_loss` (mlsp.py:275-287): -mean |cos|."""
    cos = (_unit(pred) * _unit(gt)).sum(-1)
    return -weight * cos.abs().mean()


def region_weights(mask: torch.Tensor, defpart: bool,
                   boost: float = 26.0) -> torch.Tensor:
    """Per-point loss weights from the deform mask: deformed points weigh
    27x (mask·26 + 1, `PointDA/trainer.py:437-440`), or only they count
    with `Density_normal_defpart`."""
    return mask if defpart else mask * boost + 1.0


def masked_normal_loss(pred, gt, weights, weight: float) -> torch.Tensor:
    """`PointDA/trainer.py:441-448`: -sum(|cos| w) / sum(w) over the batch."""
    cos = (_unit(pred) * _unit(gt)).sum(-1).abs()  # [B, N]
    return -weight * (cos * weights).sum() / weights.sum().clamp_min(1e-12)


def density_loss(p_vec, p_val, target_vec, target_val, density_weight: float,
                 mask: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """`mlsp.densityloss` (mlsp.py:430-454) on flattened points.

    Args:
      p_vec: [M, C] predicted class probabilities (softmaxed).
      p_val: [M] predicted expected count.
      target_vec: [M, C] soft two-hot labels.
      target_val: [M] count regression target.
      mask: optional [M] per-point weights.

    Returns:
      (kl, mae): the soft-label cross-entropy (x lambda_2) and the L1 term
      (x lambda_1), each scaled by density_weight.
    """
    ll = (target_vec * torch.log(p_vec + _KL_EPS)).sum(-1)  # [M]
    ae = (p_val - target_val).abs()
    if mask is None:
        kl = -density_weight * ll.mean() * _KL_LAMBDA
        mae = density_weight * ae.mean() * _L1_LAMBDA
    else:
        denom = mask.sum().clamp_min(1e-12)
        kl = -density_weight * (ll * mask).sum() / denom * _KL_LAMBDA
        mae = density_weight * (ae * mask).sum() / denom * _L1_LAMBDA
    return kl, mae


def mixup_cross_entropy(logits, y_a, y_b, lam,
                        defrec_weight: float) -> torch.Tensor:
    """`PCM.calc_loss` (PCM.py:76-89)."""
    loss = (lam * cross_entropy(logits, y_a)
            + (1.0 - lam) * cross_entropy(logits, y_b))
    return loss * (1.0 - defrec_weight)
