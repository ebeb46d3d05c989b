"""PointSegDA datasets (counterpart of `mlsp_tpu/data/pointsegda.py`):
adobe, faust, mit and scape as .npy shards of [N, 4], xyz and a part
label 1-8 (`PointSegDA/data/dataloader.py:7-30`); a synthetic stand-in per
domain when the files are missing and `synthetic_fallback` is set.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from mlsp_tpu_torch.data import synthetic
from mlsp_tpu_torch.data.pipeline import Dataset

NUM_POINTS = 2048
NUM_CLASSES = 8
# The synthetic stand-ins: a seed per domain, offset by the partition;
# 48 train, 16 val and 16 test clouds.
_SYNTHETIC_SEED = {"adobe": 40, "faust": 50, "mit": 60, "scape": 70}
_SYNTHETIC_PART = {"train": (0, 48), "val": (1, 16), "test": (2, 16)}


def load_pointsegda(name: str, dataroot: str, partition: str = "train",
                    synthetic_fallback: bool = False,
                    num_points: int = NUM_POINTS) -> Dataset:
    """One PointSegDA domain: data [M, N, 3] float32, labels [M, N] int64
    in 0-7. `num_points` sizes the synthetic stand-in only; the real
    shards are fixed 2048-point clouds."""
    files = sorted(glob.glob(os.path.join(dataroot, name, partition,
                                          "*.npy")))
    if not files:
        if not synthetic_fallback:
            raise FileNotFoundError(
                f"no PointSegDA npy files under {dataroot}/{name}/{partition}")
        offset, count = _SYNTHETIC_PART[partition]
        data, labels = synthetic.make_segmentation(
            count, num_points, NUM_CLASSES,
            seed=_SYNTHETIC_SEED[name] + offset)
        return Dataset(data, labels)

    raw = [np.load(f) for f in files]
    data = np.stack([r[:, :3].astype(np.float32) for r in raw])
    labels = np.stack([r[:, 3].astype(np.int64) - 1 for r in raw])  # 1-8 -> 0-7
    return Dataset(data, labels)
