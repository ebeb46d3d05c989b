"""Simulated single-view scan occlusion (counterpart of
`mlsp_tpu/transforms/scan.py`, the reference's `mlsp.scan_input` /
`p_scan`, `MLSP/mlsp.py:54-89`).

Rotate each cloud randomly in 3D, project it onto a (y, z) pixel grid,
keep only the front-most point (largest x) of each pixel and zero the
rest. Two segment reductions on the device: the per-cell max depth, then
the lowest point index among the points at that depth (the reference's
first-wins scan). The cell count (2/pixel_size)² depends on the draw, so
cells are reduced over the static bound `_MAX_CELLS`.

The pixel size is drawn once per call, uniform on [0.045, 0.075), as the
reference draws it once per batch. As the other transforms, the draw
(`draw_scan`) is split from the apply (`scan_batch`), which takes the
rotation matrices.
"""

from __future__ import annotations

import torch

from mlsp_tpu_torch.transforms import augment

_PIX_MIN, _PIX_MAX = 0.045, 0.075
# pixel = int(2/pixel_size) <= int(2/0.045) = 44; lists are (pixel+5)^2 long.
_MAX_CELLS = (44 + 5) * (44 + 5)


def draw_scan(generator: torch.Generator, batch: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(pixel size, a float32 scalar; rotation matrices [batch, 3, 3] of
    `augment.rotation_3d`)."""
    u = torch.rand((), generator=generator, device=generator.device)
    pixel_size = u * (_PIX_MAX - _PIX_MIN) + _PIX_MIN
    return pixel_size, augment.rotation_3d(
        augment.draw_rotation_3d(generator, batch))


def scan_batch(x: torch.Tensor, pixel_size: torch.Tensor,
               rotation: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Occlude each cloud x [B, N, 3] to a simulated single-view scan.

    Returns (scan [B, N, 3], mask [B, N]): `scan` keeps the original
    coordinates of the surviving points and zeros elsewhere; `mask` is 1.0
    on the REMOVED points (the reconstruction targets), as `p_scan`'s."""
    B, N, _ = x.shape
    pixel = torch.floor(2.0 / pixel_size)
    rot = augment.rotate(x, rotation)
    cell = ((rot[..., 2] + 1.0) / 2.0 * pixel * pixel
            + (rot[..., 1] + 1.0) / 2.0 * pixel).long()
    cell = torch.clamp(cell, 0, _MAX_CELLS - 1)
    depth = rot[..., 0]
    front = torch.full((B, _MAX_CELLS), float("-inf"), dtype=depth.dtype,
                       device=x.device).scatter_reduce(
        1, cell, depth, "amax", include_self=False)
    is_front = depth == torch.gather(front, 1, cell)
    ids = torch.arange(N, device=x.device).expand(B, N)
    first = torch.full((B, _MAX_CELLS), N, dtype=ids.dtype,
                       device=x.device).scatter_reduce(
        1, cell, torch.where(is_front, ids, N), "amin", include_self=False)
    kept = is_front & (ids == torch.gather(first, 1, cell))
    scan = torch.where(kept[..., None], x, 0.0)
    return scan, 1.0 - kept.to(x.dtype)
