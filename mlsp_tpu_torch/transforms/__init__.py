"""Random transforms of the train steps, each split into a draw (from an
explicit `torch.Generator`) and an apply that takes the draws; `extra`
holds the reference's meta-dataloader augmentations, which no path runs."""

from mlsp_tpu_torch.transforms.augment import (
    axis_rotation,
    draw_jitter,
    draw_rotation,
    draw_rotation_3d,
    draw_translate,
    jitter,
    rotate,
    rotate_shape,
    rotation_3d,
    scale_to_unit_cube,
    translate,
)
from mlsp_tpu_torch.transforms.deform import (
    collapse_to_point_batch,
    deform_batch,
    draw_collapse,
    draw_deform,
)
from mlsp_tpu_torch.transforms.scan import draw_scan, scan_batch

__all__ = ["axis_rotation", "collapse_to_point_batch", "deform_batch",
           "draw_collapse", "draw_deform", "draw_jitter", "draw_rotation",
           "draw_rotation_3d", "draw_scan", "draw_translate", "jitter",
           "rotate", "rotate_shape", "rotation_3d", "scale_to_unit_cube",
           "scan_batch", "translate"]
