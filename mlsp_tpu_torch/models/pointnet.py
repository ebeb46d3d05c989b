"""PointNet with the classifier and DefRec heads (counterpart of
`mlsp_tpu/models/pointnet.py`, the reference's `PointNet`,
`PointDA/Models.py:26-79`).

Two T-nets (3x3 on the input, 64x64 on the features, `TransformNet` in
its `pointnet` mode), a per-point MLP 64-64-64-128-1024 and a global max.
Parameter names are the reference's state_dict (what
`mlsp_tpu.utils.torch_export.export_pointnet` emits). PointNet builds no
kNN graph and samples no points: it launches no kernel.

As in the JAX package, the transforms multiply the row vectors, x @ T.
"""

from __future__ import annotations

import torch
from torch import nn

from mlsp_tpu_torch.models.layers import (
    Classifier,
    DenseBN,
    PointMLPHead,
    TransformNet,
    check_heads,
)

HEADS = ("defrec",)


class PointNet(nn.Module):
    NAME = "pointnet"

    def __init__(self, num_classes: int = 10, dropout: float = 0.5):
        super().__init__()
        self.config = {"dropout": dropout}
        self.trans_net1 = TransformNet(3, "pointnet")
        self.trans_net2 = TransformNet(64, "pointnet")
        widths = (3, 64, 64, 64, 128)
        for i, (a, b) in enumerate(zip(widths, widths[1:])):
            setattr(self, f"conv{i + 1}", DenseBN(a, b, "relu", True,
                                                  conv=True))
        self.conv5 = DenseBN(128, 1024, "relu", True, conv=True)
        self.C = Classifier(1024, num_classes, dropout, model="pointnet")
        self.DefRec = PointMLPHead(320 + 1024, 3, dropout)

    def forward(self, x: torch.Tensor, heads: tuple[str, ...] = (),
                generator: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
        """x [B, N, 3] -> {"feat" [B, 1024], "cls"[, "defrec" [B, N, 3]]}."""
        check_heads(heads, HEADS, self.NAME)
        x = torch.einsum("bnc,bcd->bnd", x, self.trans_net1(x))
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        x = torch.einsum("bnc,bcd->bnd", x2, self.trans_net2(x2))
        x3 = self.conv3(x)
        x4 = self.conv4(x3)
        x_cat = torch.cat([x1, x2, x3, x4], dim=-1)  # [B, N, 320]
        x5 = self.conv5(x4).amax(1)  # [B, 1024]
        out = {"feat": x5, "cls": self.C(x5, generator)}
        if "defrec" in heads:
            out["defrec"] = self.DefRec((x_cat, x5), generator)
        return out
