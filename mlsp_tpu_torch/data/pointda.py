"""PointDA-10 datasets (counterpart of `mlsp_tpu/data/pointda.py`):
ModelNet and ShapeNet as .npy trees, ScanNet as .h5 files, standardised
once by `data.pipeline`; a synthetic stand-in per domain when the files
are missing and `synthetic_fallback` is set.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from mlsp_tpu_torch.data import synthetic
from mlsp_tpu_torch.data.pipeline import (
    Dataset,
    standardize_clouds,
    standardize_files,
)

NUM_POINTS = 1024  # PointDA/data/dataloader.py:11
label_to_idx = {
    "bathtub": 0, "bed": 1, "bookshelf": 2, "cabinet": 3, "chair": 4,
    "lamp": 5, "monitor": 6, "plant": 7, "sofa": 8, "table": 9,
}
idx_to_label = {v: k for k, v in label_to_idx.items()}

# The synthetic stand-ins: a seed and a noise level per domain, so that
# source -> target transfer is not trivial; 320 train and 80 test clouds.
_SYNTHETIC_SEED = {"modelnet": 10, "shapenet": 20, "scannet": 30}
_SYNTHETIC_NOISE = {"modelnet": 0.01, "shapenet": 0.02, "scannet": 0.05}


def _npy_tree_files(dataroot: str, name: str, partition: str):
    root = os.path.join(dataroot, "PointDA_data", name)
    files = sorted(glob.glob(os.path.join(root, "*", partition, "*.npy")))
    if not files:
        raise FileNotFoundError(f"no {name} npy files under {root}")
    labels = np.asarray([label_to_idx[f.split(os.sep)[-3]] for f in files],
                        np.int64)
    return files, labels


def _load_scannet_h5(dataroot: str, partition: str):
    root = os.path.join(dataroot, "PointDA_data", "scannet")
    files = sorted(glob.glob(os.path.join(root, f"{partition}_*.h5")))
    if not files:
        raise FileNotFoundError(f"no scannet h5 files under {root}")
    import h5py

    datas, labels = [], []
    for fn in files:
        with h5py.File(fn, "r") as f:
            datas.append(f["data"][:])
            labels.append(f["label"][:])
    return (list(np.concatenate(datas, 0).astype(np.float32)),
            np.concatenate(labels, 0).astype(np.int64).reshape(-1))


def load_pointda(name: str, dataroot: str, partition: str = "train",
                 num_points: int = NUM_POINTS,
                 synthetic_fallback: bool = False, seed: int = 1,
                 device: str | torch.device | None = None) -> Dataset:
    """One PointDA domain as a fixed-shape Dataset (train: with its split).

    Alignment rotations as `dataloader.py:101-103,206-209`: ScanNet always
    -pi/2 about x, ShapeNet -pi/2 about x but for class "plant", ModelNet
    none. Clouds larger than num_points are FPS-reduced on `device` (see
    `pipeline.standardize_clouds`).
    """
    try:
        files = None
        if name == "scannet":
            clouds, labels = _load_scannet_h5(dataroot, partition)
            rot_axis, rot_mask = "x", None
        elif name in ("modelnet", "shapenet"):
            files, labels = _npy_tree_files(dataroot, name, partition)
            rot_axis = "x" if name == "shapenet" else None
            rot_mask = (labels != label_to_idx["plant"]
                        if name == "shapenet" else None)
        else:
            raise ValueError(f"unknown PointDA domain {name!r}")
    except FileNotFoundError:
        if not synthetic_fallback:
            raise
        data, labels = synthetic.make_classification(
            320 if partition == "train" else 80, num_points,
            seed=_SYNTHETIC_SEED[name] + (0 if partition == "train" else 1),
            noise=_SYNTHETIC_NOISE[name])
        ds = Dataset(data, labels)
        return ds.split(seed) if partition == "train" else ds

    kw = dict(rotate_axis=rot_axis, rotate_angle=-np.pi / 2,
              rotate_mask=rot_mask, device=device)
    data = (standardize_files(files, num_points, **kw) if files is not None
            else standardize_clouds(clouds, num_points, **kw))
    ds = Dataset(data, labels)
    return ds.split(seed) if partition == "train" else ds
