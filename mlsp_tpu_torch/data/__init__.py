"""Data for the port: PointDA-10 loaders, the in-memory pipeline and
synthetic clouds (PointSegDA comes with its slice, ROADMAP.md)."""

from mlsp_tpu_torch.data import synthetic
from mlsp_tpu_torch.data.pipeline import Dataset, batches, standardize_clouds
from mlsp_tpu_torch.data.pointda import (
    idx_to_label,
    label_to_idx,
    load_pointda,
)

__all__ = [
    "Dataset",
    "batches",
    "standardize_clouds",
    "load_pointda",
    "label_to_idx",
    "idx_to_label",
    "synthetic",
]
