"""Segmentation DGCNN for PointSegDA (counterpart of
`mlsp_tpu/models/dgcnn_seg.py`, the reference's `DGCNN_DefRec`,
`PointSegDA/Models.py:146-242`).

Channels-last: an input transform net (1x1 convs and LeakyReLU, no
BatchNorm), three *linear* EdgeConv blocks (the reference's
`shared_layers` apply no activation and no norm), a 1024-wide global
feature, and the heads "seg", "defrec", "normal" and "density".

Parameter names follow the reference's state_dict (what
`mlsp_tpu.utils.torch_export.export_dgcnn_seg` emits) wherever the JAX
package's parameters map to it one to one: `input_transform_net.*`,
`shared_layers.conv6`, `seg.*`, `DefRec.*`, `Norm_pred.*`,
`Density_cls.*`. The linear edge blocks keep the JAX package's
parameterisation, because the reference's conv pairs are not one to one
with it (the export solves for them with a pseudo-inverse) and Adam's
update depends on the parameterisation:

  shared_layers.edge{1,2,3}.w_diff{j}.weight     [out, in], no bias
  shared_layers.edge{1,2,3}.w_center{j}.weight   [out, in], and .bias

(j = 0, 1 for edge1 and edge2, j = 0 for edge3). A reference-loadable
`model.pt` is the `export` of ROADMAP.md's Slice G.

Every kNN graph is built through `mlsp_tpu_torch.ops.knn.knn_indices` (on
the card the K1 kernel, which takes bf16 features upcast to float32),
looked up on its module at each call.

`compute_dtype="bf16"` (the seg trainer's; the JAX `dtype`) runs the edge
blocks and `conv6` in bf16 with float32 parameters, as flax's `dtype`
does (`layers.set_compute_dtype`): the transform net stays float32, the
global feature is float32 and the heads, which the JAX model builds
without a dtype, take the bf16 per-point features promoted to float32.
"""

from __future__ import annotations

import torch
from torch import nn

from mlsp_tpu_torch.models.layers import (
    DenseBN,
    DensityHead,
    Linear,
    PointMLPHead,
    PointwiseConv,
    check_heads,
    parse_dtype,
    set_compute_dtype,
)
from mlsp_tpu_torch.ops import knn as knn_ops

SEG_HEADS = ("seg", "defrec", "normal", "density")


class LinearEdgeBlock(nn.Module):
    """Linear (double) EdgeConv and max over k, decomposed (the JAX
    `LinearEdgeBlock`).

    For linear maps the edge value of the reference's layers is
    u_j - u_i + w_i, with u = W_d x (the `w_diff` chain) and w the
    `w_center` chain with its biases, and the max over the neighbours j
    distributes: max_j u_j - u_i + w_i. No [B, N, k, C] edge tensor of
    the layer's convs is built; the max runs over gathered u. Its
    gradient is shared equally among tied neighbours, as JAX's max does.
    """

    def __init__(self, cin: int, widths: tuple[int, ...]):
        super().__init__()
        dims = (cin, *widths)
        for j, (a, b) in enumerate(zip(dims, dims[1:])):
            setattr(self, f"w_diff{j}", Linear(a, b, bias=False))
            setattr(self, f"w_center{j}", Linear(a, b))
        self.depth = len(widths)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        u = w = x
        for j in range(self.depth):
            u = getattr(self, f"w_diff{j}")(u)
            w = getattr(self, f"w_center{j}")(w)
        return knn_ops.knn_gather(u, idx).amax(-2) - u + w


class SegTransformNet(nn.Module):
    """The PointSegDA 3x3 input transform (`PointSegDA/Models.py:106-143`):
    edge features [B, N, k, 6] through 1x1 convs 64, 128 (max over k),
    1024 (max over N), then 512, 256 and 9, each with LeakyReLU 0.2 but
    the last, and no BatchNorm; the identity is added."""

    def __init__(self, out: int = 3):
        super().__init__()
        self.out = out
        self.conv2d1 = DenseBN(2 * out, 64, "leakyrelu", False, conv=True,
                               use_bn=False)
        self.conv2d2 = DenseBN(64, 128, "leakyrelu", False, conv=True,
                               use_bn=False)
        self.conv2d3 = DenseBN(128, 1024, "leakyrelu", False, conv=True,
                               use_bn=False)
        self.fc1 = DenseBN(1024, 512, "leakyrelu", True, conv=False,
                           use_bn=False)
        self.fc2 = DenseBN(512, 256, "leakyrelu", True, conv=False,
                           use_bn=False)
        self.fc3 = Linear(256, out * out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2d2(self.conv2d1(x)).amax(-2)  # over k
        x = self.conv2d3(x).amax(-2)  # over N
        x = self.fc3(self.fc2(self.fc1(x)))
        eye = torch.eye(self.out, dtype=x.dtype, device=x.device).reshape(-1)
        return (x + eye).reshape(x.shape[0], self.out, self.out)


class SegPointHead(PointMLPHead):
    """Per-point head with biases (`segmentation` and
    `DeformationReconstruction`, `PointSegDA/Models.py:245-296`)."""

    def __init__(self, cin: int, out: int, dropout: float = 0.5):
        super().__init__(cin, out, dropout, bias=True)


class SharedLayers(nn.Module):
    """The reference's `shared_layers`: three linear edge blocks and the
    1x1 conv to the 1024-wide per-point feature (`conv6`)."""

    def __init__(self):
        super().__init__()
        self.edge1 = LinearEdgeBlock(3, (64, 64))
        self.edge2 = LinearEdgeBlock(64, (64, 64))
        self.edge3 = LinearEdgeBlock(64, (64,))
        self.conv6 = PointwiseConv(192, 1024, 1, True)


class DGCNNSeg(nn.Module):
    """PointSegDA DGCNN with its four heads (the reference builds every
    head, so a model holds them all).

    `knn_backend` picks the kNN path ("auto": the kernel for CUDA
    tensors, the plain version for CPU tensors; "torch": the plain version
    anywhere); `compute_dtype` ("f32" | "bf16") the edge blocks' and
    conv6's precision (see the module docstring).
    """

    NAME = "dgcnn_seg"

    def __init__(self, num_classes: int = 8, k: int = 20,
                 dropout: float = 0.5, density_num_cls: int = 16,
                 pergroup: float = 5.0, knn_backend: str = "auto",
                 compute_dtype: str = "f32"):
        super().__init__()
        self.dtype = parse_dtype(compute_dtype, "compute_dtype")
        self.config = {"k": k, "dropout": dropout,
                       "density_num_cls": density_num_cls,
                       "pergroup": pergroup, "compute_dtype": compute_dtype}
        self.k = k
        self.knn_backend = knn_backend
        self.input_transform_net = SegTransformNet(3)
        self.shared_layers = set_compute_dtype(SharedLayers(), self.dtype)
        cin = 192 + 1024  # [x123 | x5]
        self.seg = SegPointHead(cin, num_classes, dropout)
        self.DefRec = SegPointHead(cin, 3, dropout)
        self.Norm_pred = PointMLPHead(cin, 3, dropout)
        self.Density_cls = DensityHead(cin, density_num_cls, pergroup,
                                       dropout)

    def _knn(self, x: torch.Tensor) -> torch.Tensor:
        return knn_ops.knn_indices(x.detach(), self.k,
                                   backend=self.knn_backend)

    def forward(self, x: torch.Tensor, heads: tuple[str, ...] = ("seg",),
                generator: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
        """x [B, N, 3] -> dict with "feat" [B, 1024] and the heads asked
        for: "seg" [B, N, num_classes], "defrec" and "normal" [B, N, 3],
        "density" [B, N, num_cls] with "density_mse" [B, N]. In train mode
        with dropout, the masks come from `generator` (on x's device)."""
        check_heads(heads, SEG_HEADS, self.NAME)
        T = self.input_transform_net(
            knn_ops.edge_features(x, self._knn(x)))
        # The reference applies T @ x_col; channels-last that is x_row @ T^T.
        x = torch.einsum("bnc,bdc->bnd", x, T)
        if self.dtype is not None:
            x = x.to(self.dtype)

        sl = self.shared_layers
        x1 = sl.edge1(x, self._knn(x))
        x2 = sl.edge2(x1, self._knn(x1))
        x3 = sl.edge3(x2, self._knn(x2))
        x123 = torch.cat([x1, x2, x3], dim=-1)  # [B, N, 192]
        x5 = sl.conv6(x123).amax(1).float()  # global feature [B, 1024]

        pp = (x123, x5)  # the heads' input, concat [x123 | x5] implied
        out = {"feat": x5}
        if "seg" in heads:
            out["seg"] = self.seg(pp, generator)
        if "defrec" in heads:
            out["defrec"] = self.DefRec(pp, generator)
        if "normal" in heads:
            out["normal"] = self.Norm_pred(pp, generator)
        if "density" in heads:
            out["density"], out["density_mse"] = self.Density_cls(
                pp, generator)
        return out
