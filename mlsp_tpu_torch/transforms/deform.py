"""DefRec deformations (counterpart of `mlsp_tpu/transforms/deform.py`).

`deform_batch` ports `mlsp.deform_input` (`MLSP/mlsp.py:10-51`): split the
cube [-1, 1]³ into n³ voxels, pick a random voxel holding >= MIN_PTS
points, and replace its points with gaussian noise around the voxel
centre. `collapse_to_point_batch` ports the `volume_based_radius` variant
(`pc_utils.collapse_to_point`): collapse the RADIUS ball around a random
well-populated point.

Each is split into a draw (random numbers from an explicit
`torch.Generator`) and an apply that takes them, so a test can feed the
JAX package's draws to the apply and hold it exactly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from mlsp_tpu_torch.ops.pairwise import pairwise_sqdist
from mlsp_tpu_torch.parallel.mesh import (
    active_points_mesh,
    gather_points,
    points_rows,
)

NREGIONS = 3
MIN_PTS = 40  # deform_input's local min_pts (mlsp.py:27)
GAUSS_STD = 0.001 ** 0.5  # draw_from_gaussian uses covariance 0.001 I
RADIUS = 0.5  # pc_utils.RADIUS for the radius variant
RADIUS_MIN_POINTS = 20  # pc_utils.MIN_POINTS


def region_means(n: int = NREGIONS, device=None) -> torch.Tensor:
    """[n³, 3] voxel centres; id = ix·n² + iy·n + iz, as `assign_regions`."""
    d = 2.0 / n
    ax = -1.0 + d * (torch.arange(n, dtype=torch.float32, device=device) + 0.5)
    gx, gy, gz = torch.meshgrid(ax, ax, ax, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)


def assign_regions(x: torch.Tensor, n: int = NREGIONS) -> torch.Tensor:
    """Voxel id per point: [..., N, 3] -> int64 [..., N] (a point on a voxel
    boundary goes to the upper voxel)."""
    d = 2.0 / n
    xc = torch.clamp(x, -0.99999999, 0.99999999)
    cell = torch.clamp(torch.floor((xc + 1.0) / d), 0, n - 1).long()
    return cell[..., 0] * n * n + cell[..., 1] * n + cell[..., 2]


def draw_deform(generator: torch.Generator, shape,
                n: int = NREGIONS) -> tuple[torch.Tensor, torch.Tensor]:
    """(perm int64 [B, n³], a random order of the voxels per cloud; noise
    float32 [B, N, 3], standard normal) for clouds of `shape` [B, N, 3]."""
    B = shape[0]
    dev = generator.device
    perm = torch.argsort(torch.rand(B, n ** 3, generator=generator,
                                    device=dev), dim=-1)
    return perm, torch.randn(shape, generator=generator, device=dev)


def deform_batch(x: torch.Tensor, perm: torch.Tensor, noise: torch.Tensor,
                 n: int = NREGIONS, groups: int = 1,
                 min_pts: int = MIN_PTS) -> tuple[torch.Tensor, torch.Tensor]:
    """Collapse, per cloud, the first `groups` voxels in `perm` order that
    hold >= min_pts points to GAUSS_STD·noise around their centres.

    Returns (deformed [B, N, 3], mask [B, N], 1.0 on replaced points).
    """
    R = n ** 3
    rid = assign_regions(x, n)  # [B, N]
    counts = F.one_hot(rid, R).sum(1)  # [B, R]
    eligible = torch.gather(counts, 1, perm) >= min_pts  # in perm order
    picked = eligible & (torch.cumsum(eligible.long(), 1) <= groups)
    region_sel = torch.zeros_like(picked).scatter(1, perm, picked)
    mask = torch.gather(region_sel, 1, rid)  # [B, N] bool
    centers = region_means(n, x.device)[rid]
    deformed = torch.where(mask[..., None], centers + GAUSS_STD * noise, x)
    return deformed, mask.to(x.dtype)


def draw_collapse(generator: torch.Generator,
                  shape) -> tuple[torch.Tensor, torch.Tensor]:
    """(gumbel float32 [B, N], noise float32 [B, N, 3]) for `shape`."""
    dev = generator.device
    u = torch.rand(shape[:2], generator=generator, device=dev)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return gumbel, torch.randn(shape, generator=generator, device=dev)


def collapse_to_point_batch(x: torch.Tensor, gumbel: torch.Tensor,
                            noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pick, per cloud, the point with >= RADIUS_MIN_POINTS neighbours
    within RADIUS that maximises `gumbel` (a uniform choice among them) and
    collapse its RADIUS ball to GAUSS_STD·noise around it.

    Under an active points mesh each rank takes its rows of the distance
    matrix: the eligible points are gathered, and the picked point's row
    of `within` comes from the rank that holds it (one all-reduce over
    the points group), bit for bit the row of the whole matrix.

    Returns (deformed [B, N, 3], mask [B, N])."""
    B, N = x.shape[:2]
    mesh = active_points_mesh()
    q0, nq = (0, N) if mesh is None else points_rows(N, mesh)
    within = pairwise_sqdist(x[:, q0:q0 + nq], x) <= RADIUS ** 2
    eligible = within.sum(-1) >= RADIUS_MIN_POINTS
    if mesh is not None:
        eligible = gather_points(eligible, N, mesh)
    pick = torch.where(eligible, gumbel, float("-inf")).argmax(-1)  # [B]
    rows = torch.arange(B, device=x.device)
    point = x[rows, pick][:, None, :]
    if mesh is None:
        mask = within[rows, pick]  # [B, N]
    else:
        mine = torch.zeros((B, N), dtype=torch.int32, device=x.device)
        if nq:
            own = ((pick >= q0) & (pick < q0 + nq))[:, None]
            mine = (within[rows, (pick - q0).clamp(0, nq - 1)] & own).int()
        dist.all_reduce(mine, group=mesh.points_group)
        mask = mine > 0
    deformed = torch.where(mask[..., None], point + GAUSS_STD * noise, x)
    return deformed, mask.to(x.dtype)
