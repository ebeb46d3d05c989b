"""Train-time augmentation (counterpart of `mlsp_tpu/transforms/augment.py`):
a random rotation about one axis and clipped gaussian jitter.

Each random transform is split into a draw, which takes the random numbers
from an explicit `torch.Generator`, and an apply, which takes them as
tensors: a test can feed the apply the JAX package's own draws and hold it
exactly. Clouds are channels-last [B, N, 3].
"""

from __future__ import annotations

import math

import torch


def axis_rotation(angles: torch.Tensor, axis: str = "z") -> torch.Tensor:
    """Rotation matrices [..., 3, 3] about one axis, for angles [...], in
    the row-vector convention of `pc_utils.rotate_shape` (x @ R)."""
    c, s = torch.cos(angles), torch.sin(angles)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    if axis == "x":
        rows = [o, z, z, z, c, -s, z, s, c]
    elif axis == "y":
        rows = [c, z, s, z, o, z, -s, z, c]
    elif axis == "z":
        rows = [c, -s, z, s, c, z, z, z, o]
    else:
        raise ValueError(f"unknown axis {axis!r}")
    return torch.stack(rows, dim=-1).reshape(*c.shape, 3, 3)


def draw_rotation(generator: torch.Generator, batch: int) -> torch.Tensor:
    """One angle per cloud, uniform on [0, 2π): float32 [batch]."""
    return torch.rand(batch, generator=generator,
                      device=generator.device) * (2.0 * math.pi)


def rotate(x: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Rotate each cloud of x [B, N, 3] by its matrix R [B, 3, 3] (x @ R).

    Written out as x0 R[0] + x1 R[1] + x2 R[2], left to right, one rounding
    per operation: the JAX package's einsum evaluates exactly this on the
    CPU, where a batched matmul would round differently."""
    R = R.to(x.dtype)[:, None]  # [B, 1, 3, 3]
    return (x[..., 0:1] * R[..., 0, :] + x[..., 1:2] * R[..., 1, :]
            + x[..., 2:3] * R[..., 2, :])


def draw_jitter(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard normal noise of `shape`."""
    return torch.randn(shape, generator=generator, device=generator.device)


def jitter(x: torch.Tensor, noise: torch.Tensor, sigma: float = 0.01,
           clip: float = 0.02) -> torch.Tensor:
    """x + clip(sigma * noise, ±clip) (`pc_utils.jitter_pointcloud`)."""
    return x + torch.clamp(sigma * noise, -clip, clip)
