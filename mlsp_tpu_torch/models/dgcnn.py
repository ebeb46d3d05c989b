"""DGCNN encoder with the MLSP heads (counterpart of `mlsp_tpu/models/dgcnn.py`).

Channels-last, parameters in the reference `DGCNN` state_dict layout (see
`models/layers.py`). The EdgeConv layers run through the neighbourhood
statistics (`ops.edge.edge_moments`: on the card the kNN kernel, K2-fwd
and, in training, K2-bwd).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mlsp_tpu_torch.models.layers import (
    Classifier,
    DensityHead,
    PointMLPHead,
    PointwiseConv,
    TransformNet,
    batch_norm,
    check_heads,
)
from mlsp_tpu_torch.ops.edge import edge_moments
from mlsp_tpu_torch.ops.knn import edge_features, knn_gather, knn_indices

HEADS = ("defrec", "normal", "scan", "density")


class EdgeConv(nn.Module):
    """EdgeConv + BN + LeakyReLU + max over k in the gather form (the JAX
    `EdgeConv`, which Point-ViT's DGCNN group embedder runs): u = W_d x,
    v = W_c x, the edge tensor z_ij = u_j + (v - u)_i is built, BatchNorm
    normalises it over every [B, N, k] position (train mode: its batch
    statistics), then LeakyReLU 0.2 and the max over k. Plain PyTorch, as
    JAX runs it outside any Pallas kernel. Flax names: `w_diff`,
    `w_center` (bias-free nn.Linear) and `BatchNorm_0`."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.w_diff = nn.Linear(cin, cout, bias=False)
        self.w_center = nn.Linear(cin, cout, bias=False)
        self.BatchNorm_0 = nn.BatchNorm1d(cout)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        u = self.w_diff(x)
        z = knn_gather(u, idx) + (self.w_center(x) - u)[:, :, None, :]
        return F.leaky_relu(batch_norm(self.BatchNorm_0, z), 0.2).amax(-2)


class EdgeConvM(nn.Module):
    """EdgeConv + BN + LeakyReLU + max over k, through neighbourhood
    statistics (the JAX `EdgeConvM`).

    The reference applies `max_k act(BN(W [x_j - x_i | x_i]))`. With
    W = [W_d | W_c], u = W_d x and v = W_c x, the edge value is
    u_j - u_i + v_i, and since BN is affine and LeakyReLU monotone,

        max_j act(BN(z_ij)) = act(s * ((s >= 0 ? max_j u_j : min_j u_j)
                                       + v_i - u_i - mean) + beta),
        s = gamma / sqrt(var + eps),

    a negative gamma turning the max into a min. The reference's direct
    form and this one share the state_dict: `conv.0.weight` [out, 2 cin,
    1, 1] = [W_d | W_c] and `conv.1` the BN of the edge tensor.

    In train mode the BN statistics of the virtual [B, N, k, C] edge tensor
    z_ij = u_j + c_i (c = v - u) come from the neighbourhood sums s1 and
    s2 (means over k): mean = E[s1 + c], E[z²] = E[s2 + 2 c s1 + c²],
    var = max(E[z²] - mean², 0); the running statistics take torch's
    momentum and the unbiased variance over n = B·N·k.
    """

    def __init__(self, cin: int, cout: int, k: int, knn_backend: str):
        super().__init__()
        self.conv = nn.ModuleList([PointwiseConv(2 * cin, cout, 2, False),
                                   nn.BatchNorm1d(cout)])
        self.k = k
        self.knn_backend = knn_backend

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv[0].weight.flatten(1)
        cin = x.shape[-1]
        u = F.linear(x, w[:, :cin])
        c = F.linear(x, w[:, cin:]) - u
        bn = self.conv[1]
        if self.training:
            mx, mn, s1, s2 = edge_moments(x, u, self.k, True,
                                          backend=self.knn_backend)
            s1, s2 = s1 / self.k, s2 / self.k
            mu = (s1 + c).mean((0, 1))
            ez2 = (s2 + 2.0 * c * s1 + c * c).mean((0, 1))
            var = torch.clamp_min(ez2 - mu * mu, 0.0)
            with torch.no_grad():
                n = x.shape[0] * x.shape[1] * self.k
                m = bn.momentum
                bn.running_mean.mul_(1.0 - m).add_(m * mu)
                bn.running_var.mul_(1.0 - m).add_(m * var * (n / max(n - 1, 1)))
                bn.num_batches_tracked.add_(1)
        else:
            mx, mn = edge_moments(x, u, self.k, False,
                                  backend=self.knn_backend)
            mu, var = bn.running_mean, bn.running_var
        s = bn.weight * torch.rsqrt(var + bn.eps)
        sel = torch.where(s >= 0, mx, mn)
        y = s * (sel + c - mu) + bn.bias
        return F.leaky_relu(y, negative_slope=0.2)


class DGCNN(nn.Module):
    """PointDA DGCNN: input transform, EdgeConv 64/64/128/256, a 1024-wide
    global feature, the classifier and the four MLSP heads (the reference
    builds every head, so a strict load needs them all).

    `knn_backend` picks the kNN and statistics path ("auto": the kernels
    for CUDA tensors, their plain versions for CPU tensors; "torch": the
    plain versions anywhere). `head_dtype="bf16"` runs the per-point heads
    under bf16 autocast (BatchNorm stays float32) and returns them in
    float32, as the JAX package's `head_dtype` does.
    """

    NAME = "dgcnn"

    def __init__(self, num_classes: int = 10, k: int = 20,
                 dropout: float = 0.5, density_num_cls: int = 16,
                 pergroup: float = 2.0, knn_backend: str = "auto",
                 head_dtype: str = "f32"):
        super().__init__()
        if head_dtype not in ("f32", "bf16"):
            raise ValueError(f"head_dtype must be 'f32' or 'bf16', got "
                             f"{head_dtype!r}")
        self.config = {"k": k, "dropout": dropout,
                       "density_num_cls": density_num_cls,
                       "pergroup": pergroup, "head_dtype": head_dtype}
        self.k = k
        self.knn_backend = knn_backend
        self.head_dtype = head_dtype
        self.input_transform_net = TransformNet(3)
        self.conv1 = EdgeConvM(3, 64, k, knn_backend)
        self.conv2 = EdgeConvM(64, 64, k, knn_backend)
        self.conv3 = EdgeConvM(64, 128, k, knn_backend)
        self.conv4 = EdgeConvM(128, 256, k, knn_backend)
        self.conv5 = PointwiseConv(512, 1024, 1, False)
        self.bn5 = nn.BatchNorm1d(1024)
        self.C = Classifier(1024, num_classes, dropout)
        self.DefRec = PointMLPHead(1536, 3, dropout)
        self.Norm_pred = PointMLPHead(1536, 3, dropout)
        self.Rec_scan = PointMLPHead(1536, 3, dropout)
        self.Density_cls = DensityHead(1536, density_num_cls, pergroup,
                                       dropout)

    def forward(self, x: torch.Tensor, heads: tuple[str, ...] = (),
                generator: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
        """x [B, N, 3] -> dict with "cls" [B, num_classes], "feat"
        [B, 1024] and the per-point heads asked for. In train mode with
        dropout, the masks come from `generator` (on x's device)."""
        check_heads(heads, HEADS, self.NAME)
        idx = knn_indices(x.detach(), self.k, backend=self.knn_backend)
        T = self.input_transform_net(edge_features(x, idx))
        # The reference applies T @ x_col; channels-last that is x_row @ T^T.
        x = torch.einsum("bnc,bdc->bnd", x, T)

        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        x3 = self.conv3(x2)
        x4 = self.conv4(x3)
        x_cat = torch.cat([x1, x2, x3, x4], dim=-1)  # [B, N, 512]
        x5 = F.leaky_relu(batch_norm(self.bn5, self.conv5(x_cat)), 0.2)
        x5 = x5.amax(1)  # global feature [B, 1024]

        out = {"feat": x5, "cls": self.C(x5, generator)}
        if not heads:
            return out
        pp = (x_cat, x5)  # the heads' input, concat [x_cat | x5] implied
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.head_dtype == "bf16"):
            if "defrec" in heads:
                out["defrec"] = self.DefRec(pp, generator)
            if "normal" in heads:
                out["normal"] = self.Norm_pred(pp, generator)
            if "scan" in heads:
                out["scan"] = self.Rec_scan(pp, generator)
            if "density" in heads:
                out["density"], out["density_mse"] = self.Density_cls(
                    pp, generator)
        return {name: t.float() for name, t in out.items()}
