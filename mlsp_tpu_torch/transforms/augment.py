"""Geometric augmentation (counterpart of `mlsp_tpu/transforms/augment.py`,
the reference's `pc_utils.py:190-278` and `MLSP/mlsp.py:96-112`): a random
rotation about one axis or all three, clipped gaussian jitter, a random
scale and shift, a fixed-angle rotation and unit-cube scaling.

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


def draw_rotation_3d(generator: torch.Generator, batch: int) -> torch.Tensor:
    """Three angles per cloud, uniform on [0, 2π): float32 [batch, 3]."""
    return torch.rand(batch, 3, generator=generator,
                      device=generator.device) * (2.0 * math.pi)


def rotation_3d(angles: torch.Tensor) -> torch.Tensor:
    """R = Ry(a0) @ Rx(a1) @ Rz(a2) [..., 3, 3] for angles [..., 3]: the
    rotation about all three axes of `mlsp.py:96-112`, applied as x @ R
    (`rotate`)."""
    return (axis_rotation(angles[..., 0], "y")
            @ axis_rotation(angles[..., 1], "x")
            @ axis_rotation(angles[..., 2], "z"))


def scale_to_unit_cube(x: torch.Tensor) -> torch.Tensor:
    """Centre each cloud [..., N, 3] at its centroid and scale its farthest
    point to norm 1 (`pc_utils.scale_to_unit_cube`)."""
    x = x - x.mean(-2, keepdim=True)
    far = torch.linalg.vector_norm(x, dim=-1).amax(-1)
    return x / far.clamp_min(1e-12)[..., None, None]


def rotate_shape(x: torch.Tensor, axis: str, angle: float) -> torch.Tensor:
    """Rotate clouds [..., N, 3] by a fixed angle about one axis, x @ R
    (`pc_utils.rotate_shape`, used for dataset alignment)."""
    a = torch.tensor(angle, dtype=x.dtype, device=x.device)
    return x @ axis_rotation(a, axis)


def draw_translate(generator: torch.Generator, batch: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale uniform on [2/3, 3/2), shift uniform on [-0.2, 0.2)), each
    float32 [batch, 1, 3]."""
    dev = generator.device
    s = torch.rand(batch, 1, 3, generator=generator, device=dev)
    t = torch.rand(batch, 1, 3, generator=generator, device=dev)
    return s * (3.0 / 2.0 - 2.0 / 3.0) + 2.0 / 3.0, t * 0.4 - 0.2


def translate(x: torch.Tensor, scale: torch.Tensor,
              shift: torch.Tensor) -> torch.Tensor:
    """Anisotropic scale and shift, x·scale + shift
    (`pc_utils.translate_pointcloud`); the draws from `draw_translate`."""
    return x * scale + shift
