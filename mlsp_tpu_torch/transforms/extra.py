"""The reference's meta-dataloader augmentations (counterpart of
`mlsp_tpu/transforms/extra.py`; `utils/metapc_utils.py` and
`MLSP/mlsp.py:91-94`): public transforms that no trainer of either
package calls.

As the other transforms, each random one is split into a draw (from an
explicit `torch.Generator`) and an apply that takes the draws. Clouds are
channels-last [..., N, 3]. The reference removes dropped points (a
dynamic shape); `drop_hole` and `viewpoint_dropout` return a keep mask
instead.
"""

from __future__ import annotations

import torch

from mlsp_tpu_torch.transforms.augment import axis_rotation


def normalize_pc(x: torch.Tensor) -> torch.Tensor:
    """`metapc_utils.normal_pc`: centre each cloud and divide by its largest
    norm (`augment.scale_to_unit_cube` without its clamp, under the
    reference's name)."""
    x = x - x.mean(-2, keepdim=True)
    return x / torch.linalg.vector_norm(x, dim=-1).amax(-1)[..., None, None]


def draw_scale(generator: torch.Generator, batch_shape,
               lo: float = 2.0 / 3.0, hi: float = 3.0 / 2.0) -> torch.Tensor:
    """One factor per cloud, uniform on [lo, hi): [*batch_shape, 1, 1]."""
    u = torch.rand(*batch_shape, 1, 1, generator=generator,
                   device=generator.device)
    return u * (hi - lo) + lo


def scale(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """`PointcloudScale`: x times its cloud's factor (`draw_scale`)."""
    return x * factor


def draw_rotate_perturbation(generator: torch.Generator, batch_shape,
                             angle_sigma: float = 0.06,
                             angle_clip: float = 0.18) -> torch.Tensor:
    """Three small angles per cloud, clip(sigma * N(0, 1), ±clip):
    [*batch_shape, 3]."""
    n = torch.randn(*batch_shape, 3, generator=generator,
                    device=generator.device)
    return torch.clamp(angle_sigma * n, -angle_clip, angle_clip)


def rotate_perturbation(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """`PointcloudRotatePerturbation`: x @ (Rx(a0) Ry(a1) Rz(a2)) for the
    angles of `draw_rotate_perturbation`."""
    R = (axis_rotation(angles[..., 0], "x") @ axis_rotation(angles[..., 1], "y")
         @ axis_rotation(angles[..., 2], "z"))
    return torch.einsum("...nc,...cd->...nd", x, R.to(x.dtype))


def draw_drop_hole(generator: torch.Generator, batch_shape,
                   num_points: int) -> torch.Tensor:
    """The hole's centre point, one index per cloud: int64 [*batch_shape]."""
    return torch.randint(0, num_points, tuple(batch_shape),
                         generator=generator, device=generator.device)


def drop_hole(x: torch.Tensor, center_idx: torch.Tensor,
              p: float = 0.24) -> tuple[torch.Tensor, torch.Tensor]:
    """`mlsp.drop_hole`: drop the fraction p of points nearest to each
    cloud's centre point. Returns (x, keep mask [..., N]: 1.0 where the
    squared distance to the centre is above its p-quantile)."""
    center = torch.gather(
        x, -2, center_idx[..., None, None].expand(*center_idx.shape, 1, 3))
    d = (x - center).square().sum(-1)
    thresh = torch.quantile(d, p, dim=-1, keepdim=True)
    return x, (d > thresh).to(x.dtype)


def draw_viewpoint_dropout(generator: torch.Generator,
                           shape) -> torch.Tensor:
    """One uniform number on [0, 1) per point: [*batch_shape, N]."""
    return torch.rand(*shape, generator=generator, device=generator.device)


def viewpoint_dropout(x: torch.Tensor, u: torch.Tensor,
                      v_point=(1.0, 0.0, 0.0), gate: float = 1.0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """`metapc_utils.density`: drop each point with a probability that
    grows with its distance from the viewpoint, distance / max distance
    times `gate`, decided by the draws `u`. Returns (x, keep mask [..., N])."""
    v = torch.as_tensor(v_point, dtype=x.dtype, device=x.device)
    dist = (x - v).square().sum(-1).sqrt()
    drop_p = dist / dist.amax(-1, keepdim=True) * gate
    return x, (u >= drop_p).to(x.dtype)


def draw_from_uniform(generator: torch.Generator, gap, region_mean,
                      num_points: int) -> torch.Tensor:
    """`pc_utils.draw_from_uniform`: `num_points` points uniform in the box
    region_mean ± gap: [num_points, 3]."""
    u = torch.rand(num_points, 3, generator=generator,
                   device=generator.device)
    return uniform_in_box(u, gap, region_mean)


def uniform_in_box(u: torch.Tensor, gap, region_mean) -> torch.Tensor:
    """Uniform numbers u on [0, 1) mapped into the box region_mean ± gap,
    as `jax.random.uniform` maps them (lo + u (hi - lo), at least lo)."""
    mean = torch.as_tensor(region_mean, dtype=u.dtype, device=u.device)
    gap = torch.as_tensor(gap, dtype=u.dtype, device=u.device)
    lo, hi = mean - gap, mean + gap
    return torch.maximum(lo, u * (hi - lo) + lo)
