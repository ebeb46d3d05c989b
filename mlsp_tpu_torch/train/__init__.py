"""The PointDA and PointSegDA train steps and their optimizers
(counterpart of `mlsp_tpu.train`); the trainers are
`train.pointda_trainer`, `train.pointsegda_trainer` and `train.spst`
(self-training)."""

from mlsp_tpu_torch.train.state import cosine_per_epoch, make_optimizer
from mlsp_tpu_torch.train.seg_steps import (
    pointsegda_losses,
    pointsegda_train_step,
)
from mlsp_tpu_torch.train.steps import pointda_losses, pointda_train_step

__all__ = ["cosine_per_epoch", "make_optimizer", "pointda_losses",
           "pointda_train_step", "pointsegda_losses",
           "pointsegda_train_step"]
