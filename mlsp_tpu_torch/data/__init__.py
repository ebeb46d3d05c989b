"""Data for the port: PointDA-10 and PointSegDA loaders, the in-memory
pipeline and synthetic clouds."""

from mlsp_tpu_torch.data import synthetic
from mlsp_tpu_torch.data.pipeline import Dataset, batches, standardize_clouds
from mlsp_tpu_torch.data.pointda import (
    idx_to_label,
    label_to_idx,
    load_pointda,
)
from mlsp_tpu_torch.data.pointsegda import load_pointsegda

__all__ = [
    "Dataset",
    "batches",
    "standardize_clouds",
    "load_pointda",
    "load_pointsegda",
    "label_to_idx",
    "idx_to_label",
    "synthetic",
]
