"""MLSP loss functions (counterpart of `mlsp_tpu/losses/losses.py`;
channels-last, masks [B, N]). Weights and normalisation follow the
reference; `p_vec` density predictions are post-softmax probabilities.
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


def scan_rec_loss(pred, gold, mask, scan_rec_weight: float) -> torch.Tensor:
    """`mlsp.calc_scan_loss` (mlsp.py:231-238)."""
    return (scan_rec_weight * reconstruction_loss(pred, gold, mask)
            * DEFREC_SCALER)


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


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-cloud row gather: x [B, N, ...], idx [B, N] -> [B, N, ...]."""
    if x.ndim == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def transported_normal_loss(normal_pred, normal_labels, weights, idx_pair,
                            weight: float) -> torch.Tensor:
    """`mlsp.calc_def_normal_loss` (mlsp.py:289-329): the labels carried
    onto the predictions through the pred -> gold map and the predictions
    onto the labels through the gold -> pred map (`nearest_index_pair`),
    -|cos| weighted by `weights` [B, N] (see `region_weights`), normalised
    per cloud, summed and divided by the batch, both directions."""
    i1, i2 = idx_pair
    B = normal_pred.shape[0]
    np_, nl = _unit(normal_pred), _unit(normal_labels)
    denom = weights.sum(1).clamp_min(1e-12)  # defpart masks can be empty
    t = (np_ * _gather_rows(nl, i1)).sum(-1).abs()
    loss = -((t * weights).sum(1) / denom).sum() / B
    t2 = (_gather_rows(np_, i2) * nl).sum(-1).abs()
    loss = loss - ((t2 * weights).sum(1) / denom).sum() / B
    return weight * loss


def transported_density_loss(p_vec, p_val, target_vec, target_val, weights,
                             idx_pair, density_weight: float
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """`mlsp.deform_densityloss` (mlsp.py:370-427) on batched p_vec [B, N,
    C], p_val [B, N], target_vec [B, N, C], target_val [B, N] and weights
    [B, N]. Direction 1 scores the predictions against the labels carried
    through the pred -> gold map; direction 2, as in the reference, swaps
    the roles: the carried predictions become the "target" of the labels'
    log-probabilities. Returns (kl, mae), each the sum of both
    directions."""
    i1, i2 = idx_pair
    C = p_vec.shape[-1]
    w = weights.reshape(-1)
    kl, mae = density_loss(
        p_vec.reshape(-1, C), p_val.reshape(-1),
        _gather_rows(target_vec, i1).reshape(-1, C),
        _gather_rows(target_val, i1).reshape(-1), density_weight, mask=w)
    kl1, mae1 = density_loss(
        target_vec.reshape(-1, C), target_val.reshape(-1),
        _gather_rows(p_vec, i2).reshape(-1, C),
        _gather_rows(p_val, i2).reshape(-1), density_weight, mask=w)
    return kl + kl1, mae + mae1
