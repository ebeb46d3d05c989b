"""The PointDA train step and its optimizer (counterpart of
`mlsp_tpu.train`); the trainer loop comes with the next slice."""

from mlsp_tpu_torch.train.state import cosine_per_epoch, make_optimizer
from mlsp_tpu_torch.train.steps import pointda_losses, pointda_train_step

__all__ = ["cosine_per_epoch", "make_optimizer", "pointda_losses",
           "pointda_train_step"]
