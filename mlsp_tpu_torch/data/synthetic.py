"""Procedural point clouds (a numpy copy of `mlsp_tpu/data/synthetic.py`),
so the port can make realistic clouds without the JAX package: ten
separable parametric shape classes, and body-like blobs with per-point
part labels for segmentation.
"""

from __future__ import annotations

import numpy as np


def _sphere(rng, n):
    v = rng.standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _cube(rng, n):
    p = rng.uniform(-1, 1, (n, 3))
    ax = rng.integers(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n)
    p[np.arange(n), ax] = sign
    return p


def _cylinder(rng, n):
    th = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-1, 1, n)
    return np.stack([np.cos(th), np.sin(th), z], 1)


def _cone(rng, n):
    z = rng.uniform(0, 1, n)
    th = rng.uniform(0, 2 * np.pi, n)
    r = 1.0 - z
    return np.stack([r * np.cos(th), r * np.sin(th), 2 * z - 1], 1)


def _torus(rng, n):
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    R, r = 0.8, 0.3
    return np.stack(
        [(R + r * np.cos(v)) * np.cos(u), (R + r * np.cos(v)) * np.sin(u), r * np.sin(v)], 1
    )


def _plane(rng, n):
    p = rng.uniform(-1, 1, (n, 3))
    p[:, 2] *= 0.05
    return p


def _pyramid(rng, n):
    z = rng.uniform(0, 1, n)
    s = 1.0 - z
    x = rng.uniform(-1, 1, n) * s
    y = rng.uniform(-1, 1, n) * s
    return np.stack([x, y, 2 * z - 1], 1)


def _helix(rng, n):
    t = rng.uniform(0, 4 * np.pi, n)
    return np.stack([np.cos(t), np.sin(t), t / (2 * np.pi) - 1], 1) + \
        0.05 * rng.standard_normal((n, 3))


def _two_spheres(rng, n):
    s = _sphere(rng, n) * 0.5
    s[: n // 2, 0] -= 0.6
    s[n // 2:, 0] += 0.6
    return s


def _cross(rng, n):
    p = rng.uniform(-1, 1, (n, 3)) * np.array([1.0, 0.08, 0.08])
    flip = rng.random(n) < 0.5
    p[flip] = p[flip][:, [1, 0, 2]]
    return p


_GENERATORS = [
    _sphere, _cube, _cylinder, _cone, _torus,
    _plane, _pyramid, _helix, _two_spheres, _cross,
]


def make_classification(
    num_examples: int = 320,
    num_points: int = 1024,
    num_classes: int = 10,
    seed: int = 0,
    noise: float = 0.02,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (clouds [M, N, 3] float32 unit-cube-ish, labels [M] int64)."""
    rng = np.random.default_rng(seed)
    labels = np.arange(num_examples) % num_classes
    rng.shuffle(labels)
    clouds = np.empty((num_examples, num_points, 3), np.float32)
    for i, c in enumerate(labels):
        p = _GENERATORS[c % len(_GENERATORS)](rng, num_points)
        p = p + noise * rng.standard_normal((num_points, 3))
        p = p - p.mean(0)
        p = p / np.linalg.norm(p, axis=1).max()
        clouds[i] = p.astype(np.float32)
    return clouds, labels.astype(np.int64)


def make_segmentation(
    num_examples: int = 64,
    num_points: int = 2048,
    num_classes: int = 8,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (clouds [M, N, 3] float32, labels [M, N] int64): the labels
    are height bands of a randomly stretched body-like blob (given by the
    geometry, so a segmentation net can learn them)."""
    rng = np.random.default_rng(seed)
    clouds = np.empty((num_examples, num_points, 3), np.float32)
    labels = np.empty((num_examples, num_points), np.int64)
    for i in range(num_examples):
        p = rng.standard_normal((num_points, 3)) * np.array([0.3, 0.2, 1.0])
        p = p - p.mean(0)
        p = p / np.linalg.norm(p, axis=1).max()
        z = p[:, 2]
        band = np.floor((z - z.min()) / (np.ptp(z) + 1e-9) * num_classes)
        labels[i] = np.clip(band, 0, num_classes - 1)
        clouds[i] = p.astype(np.float32)
    return clouds, labels
