"""In-memory datasets, batching and the one-time preprocessing pass
(counterpart of `mlsp_tpu/data/pipeline.py`).

Decoded clouds live as one [M, N, 3] numpy array. Preprocessing (unit
cube, alignment rotation, FPS down to a fixed N) runs once, up front: the
unit cube and the rotation in numpy on the host, FPS on the device it is
given, chunk by chunk, through `ops.fps` (on the card the K4 kernel). The
per-epoch train augmentation runs inside the train step. The native C++
ingest of the JAX package (`mlsp_tpu/native.py`) is not ported yet
(ROADMAP.md): `standardize_files` takes its numpy route.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterator

import numpy as np
import torch

from mlsp_tpu_torch.ops.fps import fps, fps_gather
from mlsp_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Dataset:
    """data: [M, N, 3] float32; label: [M] int64; train_ind/val_ind: the
    reference's 8/10-2/10 split (`PointDA/data/dataloader.py:70-73`)."""

    data: np.ndarray
    label: np.ndarray
    train_ind: np.ndarray | None = None
    val_ind: np.ndarray | None = None

    def __len__(self) -> int:
        return self.data.shape[0]

    def split(self, seed: int = 1) -> "Dataset":
        m = len(self)
        rng = np.random.default_rng(seed)
        train = np.asarray([i for i in range(m) if i % 10 < 8])
        val = np.asarray([i for i in range(m) if i % 10 >= 8])
        rng.shuffle(train)
        rng.shuffle(val)
        return dataclasses.replace(self, train_ind=train, val_ind=val)


def batch_indices(n_examples: int, batch_size: int, *,
                  indices: np.ndarray | None = None, shuffle: bool = False,
                  drop_last: bool = False,
                  rng: np.random.Generator | None = None
                  ) -> Iterator[np.ndarray]:
    """Yield the dataset indices of each batch. The shuffle happens at the
    first `next`, as in `batches`, so several iterators sharing one `rng`
    draw in the order they are first advanced."""
    # a copy: shuffling never reorders the caller's split arrays
    idx = (np.arange(n_examples) if indices is None
           else np.array(indices, copy=True))
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    for s in range(0, idx.shape[0], batch_size):
        sel = idx[s:s + batch_size]
        if drop_last and sel.shape[0] < batch_size:
            return
        yield sel


def batches(data: np.ndarray, label: np.ndarray, batch_size: int, *,
            indices: np.ndarray | None = None, shuffle: bool = False,
            drop_last: bool = False, rng: np.random.Generator | None = None
            ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (clouds, labels) numpy batches."""
    for sel in batch_indices(data.shape[0], batch_size, indices=indices,
                             shuffle=shuffle, drop_last=drop_last, rng=rng):
        yield data[sel], label[sel]


def num_batches(n_examples: int, batch_size: int, drop_last: bool) -> int:
    return n_examples // batch_size if drop_last else -(-n_examples // batch_size)


def pad_batch(x: np.ndarray, y: np.ndarray, size: int):
    """Repetition-pad a trailing partial batch to `size`; returns
    (x, y, valid_count)."""
    n = x.shape[0]
    if n == size:
        return x, y, n
    reps = -(-size // n)
    return (np.concatenate([x] * reps)[:size],
            np.concatenate([y] * reps)[:size], n)


# Clouds per FPS call. On the card K4 takes padded clouds of up to 16384
# points (`ops.kernels.fps`) and raises beyond.
_PAD_CHUNK = 64


def _unit_cube(x: np.ndarray) -> np.ndarray:
    x = x - x.mean(0)
    return x / max(float(np.linalg.norm(x, axis=1).max()), 1e-12)


def _rotate(x: np.ndarray, axis: str, angle: float) -> np.ndarray:
    c, sn = np.cos(angle), np.sin(angle)
    mats = {"x": [[1, 0, 0], [0, c, -sn], [0, sn, c]],
            "y": [[c, 0, sn], [0, 1, 0], [-sn, 0, c]],
            "z": [[c, -sn, 0], [sn, c, 0], [0, 0, 1]]}
    return x @ np.asarray(mats[axis], np.float32)


def _fps_chunk(chunk: np.ndarray, num_points: int, device: torch.device,
               backend: str) -> np.ndarray:
    """FPS from index 0 on a padded [C, P, 3] chunk -> [C, num_points, 3]."""
    x = torch.from_numpy(chunk).to(device)
    start = torch.zeros(x.shape[0], dtype=torch.int64, device=device)
    return fps_gather(x, fps(x, num_points, start, backend)).cpu().numpy()


def standardize_clouds(clouds: list[np.ndarray], num_points: int,
                       rotate_axis: str | None = None,
                       rotate_angle: float = 0.0,
                       rotate_mask: np.ndarray | None = None,
                       device: str | torch.device | None = None,
                       backend: str = "auto") -> np.ndarray:
    """Unit-cube scale, optional alignment rotation, then FPS or pad to
    num_points (the reference's `__getitem__`,
    `PointDA/data/dataloader.py:79-95`, run once). `rotate_mask` picks the
    clouds that get the rotation (ShapeNet skips "plant").

    A cloud of at most num_points is tiled up to it. A larger one is tiled
    up to the next power of two and FPS-reduced from index 0, in chunks of
    up to 64 clouds per bucket, on `device` (the CUDA card if None; it is
    only resolved when some cloud needs FPS) through `ops.fps` with
    `backend` ("auto": K4 on the card; "torch": the plain loop anywhere).
    Tiling is exact: duplicates never change the farthest-point order, and
    ties go to the first occurrence.
    """
    out = np.empty((len(clouds), num_points, 3), np.float32)
    pads: dict[int, list[int]] = {}
    prepped: list[np.ndarray | None] = []
    for i, pc in enumerate(clouds):
        pc = _unit_cube(np.asarray(pc, np.float32)[:, :3])
        if rotate_axis is not None and (rotate_mask is None or rotate_mask[i]):
            pc = _rotate(pc, rotate_axis, rotate_angle)
        if pc.shape[0] <= num_points:
            if pc.shape[0] < num_points:
                reps = -(-num_points // pc.shape[0])
                pc = np.tile(pc, (reps, 1))[:num_points]
            out[i] = pc
            prepped.append(None)
        else:
            prepped.append(pc)
            padded = 1 << (pc.shape[0] - 1).bit_length()  # next power of 2
            pads.setdefault(padded, []).append(i)

    if pads:
        device = resolve_device(device)
    for padded, ids in pads.items():
        for s in range(0, len(ids), _PAD_CHUNK):
            sel = ids[s:s + _PAD_CHUNK]
            chunk = np.empty((len(sel), padded, 3), np.float32)
            for j, i in enumerate(sel):
                pc = prepped[i]
                reps = -(-padded // pc.shape[0])
                chunk[j] = np.tile(pc, (reps, 1))[:padded]
            out[np.asarray(sel)] = _fps_chunk(chunk, num_points, device,
                                              backend)
    return out


def standardize_files(files: list[str], num_points: int,
                      rotate_axis: str | None = None,
                      rotate_angle: float = 0.0,
                      rotate_mask: np.ndarray | None = None,
                      device: str | torch.device | None = None) -> np.ndarray:
    """`standardize_clouds` on .npy files, read with numpy."""
    return standardize_clouds([np.load(f) for f in files], num_points,
                              rotate_axis=rotate_axis,
                              rotate_angle=rotate_angle,
                              rotate_mask=rotate_mask, device=device)
