"""A generic zero-padded `.npy` dataset (counterpart of
`mlsp_tpu/data/meta.py`, the reference's `PaddingData`,
`PointDA/data/meta_dataloader.py:18-95`): a list of `.npy` clouds,
each zero-padded or cut to a fixed size, split train/val 10/12-2/12. The
reference used it for ModelNet40 / ScanObjectNN pretraining; nothing in
the repository calls it.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from mlsp_tpu_torch.data.pipeline import Dataset


def load_padded_npy(root: str, pattern: str = "*.npy",
                    num_points: int = 1024, labels_from_parent: bool = True,
                    label_map: dict[str, int] | None = None) -> Dataset:
    """Load `<root>/<class>/<pattern>` (or `<root>/<pattern>`) into a
    zero-padded [M, num_points, 3] Dataset, labels from the parent
    directory's name (sorted, or `label_map`; 0 for a name it lacks), with
    the reference's 10/12 split."""
    files = sorted(glob.glob(os.path.join(root, "*", pattern))) or sorted(
        glob.glob(os.path.join(root, pattern)))
    if not files:
        raise FileNotFoundError(f"no npy files under {root}")

    clouds = np.zeros((len(files), num_points, 3), np.float32)
    labels = np.zeros((len(files),), np.int64)
    names = (sorted({f.split(os.sep)[-2] for f in files})
             if labels_from_parent else [])
    lmap = label_map or {n: i for i, n in enumerate(names)}
    for i, f in enumerate(files):
        pc = np.load(f).astype(np.float32)[:, :3]
        n = min(len(pc), num_points)
        clouds[i, :n] = pc[:n]  # zeros beyond n (meta_dataloader.py:62-66)
        if labels_from_parent:
            labels[i] = lmap.get(f.split(os.sep)[-2], 0)

    m = len(files)
    train = np.asarray([i for i in range(m) if i % 12 < 10])
    val = np.asarray([i for i in range(m) if i % 12 >= 10])
    return Dataset(clouds, labels, train_ind=train, val_ind=val)
