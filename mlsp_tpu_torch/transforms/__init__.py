"""Random transforms of the train step, each split into a draw (from an
explicit `torch.Generator`) and an apply that takes the draws."""

from mlsp_tpu_torch.transforms.augment import (
    axis_rotation,
    draw_jitter,
    draw_rotation,
    jitter,
    rotate,
)
from mlsp_tpu_torch.transforms.deform import (
    collapse_to_point_batch,
    deform_batch,
    draw_collapse,
    draw_deform,
)

__all__ = ["axis_rotation", "collapse_to_point_batch", "deform_batch",
           "draw_collapse", "draw_deform", "draw_jitter", "draw_rotation",
           "jitter", "rotate"]
