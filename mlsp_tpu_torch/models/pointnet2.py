"""PointNet++ (single-scale grouping) classifier (counterpart of
`mlsp_tpu/models/pointnet2.py`).

Two set abstractions (FPS centroids through `ops.fps.fps`, on the card
the K4 kernel; ball-query groups; a shared MLP; max per group), a global
abstraction and a 512-256 head. It has no DefRec head, so it trains under
PCM or the source-only recipe (`train.steps.check_recipe`).

The JAX package has no exporter for this model and the reference trains
none, so its parameters keep the flax module paths, '/' read as '.':

  SetAbstraction_{0,1}.DenseBN_{0,1,2}.Dense_0.{weight, bias}
  SetAbstraction_{0,1}.DenseBN_{0,1,2}.BatchNorm_0.{weight, bias,
      running_mean, running_var, num_batches_tracked}
  GlobalAbstraction_0.DenseBN_{0,1,2}.*   (as above)
  DenseBN_{0,1}.*                          the head's hidden layers
  Dense_0.{weight, bias}                   the logits

(`Dense_0.weight` is the flax kernel transposed, [out, in]; BatchNorm's
scale and bias are `weight` and `bias`.)
"""

from __future__ import annotations

import torch
from torch import nn

from mlsp_tpu_torch.models.layers import FlaxDenseBN, check_heads, dropout
from mlsp_tpu_torch.ops.fps import fps, fps_gather
from mlsp_tpu_torch.ops.grouping import ball_query, group_points


def _mlp(cin: int, widths: tuple[int, ...]) -> dict[str, FlaxDenseBN]:
    dims = (cin, *widths)
    return {f"DenseBN_{j}": FlaxDenseBN(a, b)
            for j, (a, b) in enumerate(zip(dims, dims[1:]))}


class SetAbstraction(nn.Module):
    """Sample (FPS), group (ball query), shared MLP over the local
    coordinates (and features), max per group."""

    def __init__(self, npoint: int, radius: float, nsample: int, cin: int,
                 mlp: tuple[int, ...], knn_backend: str):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.knn_backend = knn_backend
        for name, m in _mlp(cin + 3, mlp).items():
            setattr(self, name, m)
        self.depth = len(mlp)

    def forward(self, xyz, feats, start_idx):
        idx = fps(xyz.detach(), self.npoint, start_idx,
                  backend=self.knn_backend)
        centers = fps_gather(xyz, idx)
        gidx = ball_query(xyz.detach(), centers.detach(), self.radius,
                          self.nsample)
        g = group_points(xyz, feats, centers, gidx)  # [B, S, ns, 3 + C]
        for j in range(self.depth):
            g = getattr(self, f"DenseBN_{j}")(g)
        return centers, g.amax(-2)


class GlobalAbstraction(nn.Module):
    """Shared MLP over every point's [xyz | feats], then a global max."""

    def __init__(self, cin: int, mlp: tuple[int, ...]):
        super().__init__()
        for name, m in _mlp(cin + 3, mlp).items():
            setattr(self, name, m)
        self.depth = len(mlp)

    def forward(self, xyz, feats):
        g = torch.cat([xyz, feats], dim=-1)
        for j in range(self.depth):
            g = getattr(self, f"DenseBN_{j}")(g)
        return g.amax(1)


class PointNet2SSG(nn.Module):
    """SA(512, 0.2, 32; 64-64-128) -> SA(128, 0.4, 64; 128-128-256) ->
    global (256-512-1024) -> 512 -> 256 -> classes, ReLU and dropout.

    FPS starts at point 0 of every cloud unless `rng_start` = (s1, s2),
    int [B] each, is given to `forward`. `knn_backend` picks FPS's path
    ("auto": K4 for CUDA tensors; "torch": the plain loop anywhere)."""

    NAME = "pointnet2"

    def __init__(self, num_classes: int = 10, dropout: float = 0.4,
                 knn_backend: str = "auto"):
        super().__init__()
        self.config = {"dropout": dropout}
        self.p = dropout
        self.SetAbstraction_0 = SetAbstraction(512, 0.2, 32, 0, (64, 64, 128),
                                               knn_backend)
        self.SetAbstraction_1 = SetAbstraction(128, 0.4, 64, 128,
                                               (128, 128, 256), knn_backend)
        self.GlobalAbstraction_0 = GlobalAbstraction(256, (256, 512, 1024))
        self.DenseBN_0 = FlaxDenseBN(1024, 512)
        self.DenseBN_1 = FlaxDenseBN(512, 256)
        self.Dense_0 = nn.Linear(256, num_classes)

    def forward(self, x: torch.Tensor, heads: tuple[str, ...] = (),
                generator: torch.Generator | None = None, rng_start=None
                ) -> dict[str, torch.Tensor]:
        """x [B, N, 3] -> {"feat" [B, 1024], "cls" [B, num_classes]}. It
        has no per-point head: any `heads` raise ValueError."""
        check_heads(heads, (), self.NAME)
        if rng_start is None:
            s1 = s2 = torch.zeros(x.shape[0], dtype=torch.int64,
                                  device=x.device)
        else:
            s1, s2 = rng_start
        xyz1, f1 = self.SetAbstraction_0(x, None, s1)
        xyz2, f2 = self.SetAbstraction_1(xyz1, f1, s2)
        feat = self.GlobalAbstraction_0(xyz2, f2)
        h = dropout(self.DenseBN_0(feat), self.p, self.training, generator)
        h = dropout(self.DenseBN_1(h), self.p, self.training, generator)
        return {"feat": feat, "cls": self.Dense_0(h)}
