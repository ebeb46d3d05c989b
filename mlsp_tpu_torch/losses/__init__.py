"""MLSP losses (counterpart of `mlsp_tpu.losses`)."""

from mlsp_tpu_torch.losses.losses import (
    DEFREC_SCALER,
    cross_entropy,
    defrec_loss,
    density_loss,
    masked_normal_loss,
    mixup_cross_entropy,
    normal_loss,
    region_weights,
)

__all__ = ["DEFREC_SCALER", "cross_entropy", "defrec_loss", "density_loss",
           "masked_normal_loss", "mixup_cross_entropy", "normal_loss",
           "region_weights"]
