"""DGCNN encoder with the MLSP heads (counterpart of `mlsp_tpu/models/dgcnn.py`).

Channels-last, parameters in the reference `DGCNN` state_dict layout (see
`models/layers.py`). Each EdgeConv layer takes one of the JAX package's
three routes (`edge_impl`, resolved per layer): "fused", the
neighbourhood statistics through `ops.edge.edge_moments` (on the card the
kNN kernel K1, K2-fwd and, in training, K2-bwd); "moments", the same
statistics from a plain gather over the K1 graph (`gather_dtype` rounds
its gathered features); "direct", the edge tensor built and normalised
over every edge. "auto" takes the card's calibration record per layer
shape (`utils.chipcal.edge_impl`), "moments" off the card.
`compute_dtype="bf16"` runs the trunk as flax's `dtype` does
(`layers.set_compute_dtype`): bf16 matmuls over float32 parameters,
BatchNorm and the EdgeConv statistics in float32, bf16 features between
the layers; the kernels take them upcast to float32, as the JAX package's
Pallas calls do.
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
    dense,
    leaky_relu,
    parse_dtype,
    set_compute_dtype,
)
from mlsp_tpu_torch.ops.edge import edge_moments
from mlsp_tpu_torch.ops.knn import edge_features, knn_gather, knn_indices
from mlsp_tpu_torch.parallel.mesh import active_mesh, global_sum
from mlsp_tpu_torch.utils import chipcal

HEADS = ("defrec", "normal", "scan", "density")
EDGE_IMPLS = ("auto", "fused", "moments", "direct")
ROUTES = ("fused", "moments", "direct")


def edge_direct(u: torch.Tensor, c: torch.Tensor, idx: torch.Tensor,
                bn: nn.BatchNorm1d) -> torch.Tensor:
    """The direct form of EdgeConv + BN + LeakyReLU + max over k: the edge
    tensor z_ij = u_j + c_i built over [B, N, k, C], BatchNorm over every
    edge (train mode: its batch statistics, global under a mesh, running
    statistics with the unbiased variance over B·N·k), LeakyReLU 0.2,
    the max over k. Plain PyTorch, as JAX runs it outside any Pallas
    kernel."""
    z = knn_gather(u, idx) + c[:, :, None, :]
    return leaky_relu(batch_norm(bn, z)).amax(-2)


class EdgeConv(nn.Module):
    """EdgeConv in the direct form (the JAX `EdgeConv`, which Point-ViT's
    DGCNN group embedder runs): u = W_d x, v = W_c x, then `edge_direct`
    of u and v - u. Flax names: `w_diff`, `w_center` (bias-free
    nn.Linear) and `BatchNorm_0`."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.w_diff = nn.Linear(cin, cout, bias=False)
        self.w_center = nn.Linear(cin, cout, bias=False)
        self.BatchNorm_0 = nn.BatchNorm1d(cout)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        u = self.w_diff(x)
        return edge_direct(u, self.w_center(x) - u, idx, self.BatchNorm_0)


class EdgeConvM(nn.Module):
    """One DGCNN EdgeConv layer (EdgeConv + BN + LeakyReLU + max over k)
    on a route: "fused" and "moments" (the JAX `EdgeConvM`, with and
    without `kernel_k`) or "direct" (the JAX `EdgeConv`, `edge_direct`).
    The three share the reference state_dict: `conv.0.weight` [out,
    2 cin, 1, 1] = [W_d | W_c] and `conv.1` the BN of the edge tensor.

    The reference applies `max_k act(BN(W [x_j - x_i | x_i]))`. With
    u = W_d x and v = W_c x, the edge value is u_j - u_i + v_i, and since
    BN is affine and LeakyReLU monotone,

        max_j act(BN(z_ij)) = act(s * ((s >= 0 ? max_j u_j : min_j u_j)
                                       + v_i - u_i - mean) + beta),
        s = gamma / sqrt(var + eps),

    a negative gamma turning the max into a min. In train mode the BN
    statistics of the virtual [B, N, k, C] edge tensor z_ij = u_j + c_i
    (c = v - u) come from the neighbourhood sums s1 and s2 (means over
    k): mean = E[s1 + c], E[z²] = E[s2 + 2 c s1 + c²], var = max(E[z²] -
    mean², 0); the running statistics take torch's momentum and the
    unbiased variance over n = B·N·k. Inside `parallel.data_parallel` the
    means are over every rank's rows.

    Precision (flax's): u and v in `dtype` (None: x's); on the "moments"
    route `gather_dtype` rounds them before the gather; "fused" takes x
    and u upcast to float32 (the kernels are float32); the statistics run
    in float32 and the output is in `dtype`, never `gather_dtype`, so the
    next layer's graph is built on unrounded features.
    """

    def __init__(self, cin: int, cout: int, k: int, knn_backend: str,
                 dtype: torch.dtype | None = None,
                 gather_dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = nn.ModuleList([PointwiseConv(2 * cin, cout, 2, False),
                                   nn.BatchNorm1d(cout)])
        self.cout, self.k = cout, k
        self.knn_backend = knn_backend
        self.dtype, self.gather_dtype = dtype, gather_dtype

    def forward(self, x: torch.Tensor, route: str = "fused") -> torch.Tensor:
        if route not in ROUTES:
            raise ValueError(f"EdgeConv route must be one of {ROUTES}, got "
                             f"{route!r}")
        w = self.conv[0].weight.flatten(1)
        cin = x.shape[-1]
        u = dense(x, w[:, :cin], dtype=self.dtype)
        v = dense(x, w[:, cin:], dtype=self.dtype)
        out_dtype = u.dtype
        if route == "moments" and self.gather_dtype is not None:
            u, v = u.to(self.gather_dtype), v.to(self.gather_dtype)
        c = v - u
        bn = self.conv[1]
        if route == "direct":
            idx = knn_indices(x.detach(), self.k, backend=self.knn_backend)
            return edge_direct(u, c, idx, bn)
        train = self.training
        if route == "fused":
            stats = edge_moments(x, u.float(), self.k, train,
                                 backend=self.knn_backend)
        else:
            idx = knn_indices(x.detach(), self.k, backend=self.knn_backend)
            g = knn_gather(u, idx)
            stats = (g.amax(-2), g.amin(-2))
            if train:
                g = g.float()
                stats += (g.sum(-2), (g * g).sum(-2))
        mx, mn = stats[0].float(), stats[1].float()
        c = c.float()
        if train:
            s1, s2 = stats[2] / self.k, stats[3] / self.k
            mesh = active_mesh()
            if mesh is None:
                mu = (s1 + c).mean((0, 1))
                ez2 = (s2 + 2.0 * c * s1 + c * c).mean((0, 1))
                rows = x.shape[0] * x.shape[1]
            else:  # every rank's rows (`parallel.data_parallel`)
                rows = x.shape[0] * x.shape[1] * mesh.size
                mu, ez2 = global_sum(torch.stack([
                    (s1 + c).sum((0, 1)),
                    (s2 + 2.0 * c * s1 + c * c).sum((0, 1))])) / rows
            var = torch.clamp_min(ez2 - mu * mu, 0.0)
            with torch.no_grad():
                n = rows * self.k
                m = bn.momentum
                bn.running_mean.mul_(1.0 - m).add_(m * mu)
                bn.running_var.mul_(1.0 - m).add_(m * var * (n / max(n - 1, 1)))
                bn.num_batches_tracked.add_(1)
        else:
            mu, var = bn.running_mean, bn.running_var
        s = bn.weight * torch.rsqrt(var + bn.eps)
        sel = torch.where(s >= 0, mx, mn)
        y = s * (sel + c - mu) + bn.bias
        return F.leaky_relu(y, negative_slope=0.2).to(out_dtype)


class DGCNN(nn.Module):
    """PointDA DGCNN: input transform, EdgeConv 64/64/128/256, a 1024-wide
    global feature, the classifier and the four MLSP heads (the reference
    builds every head, so a strict load needs them all).

    `knn_backend` picks the kNN and statistics path ("auto": the kernels
    for CUDA tensors, their plain versions for CPU tensors; "torch": the
    plain versions anywhere). `edge_impl` picks each EdgeConv layer's
    route (see the module docstring; `edge_routes`). `compute_dtype`
    ("f32" | "bf16") is the trunk's precision, `head_dtype` ("f32" |
    "bf16" | "") the per-point heads', which run in bf16 if either is
    "bf16", as the JAX package's `head_dtype` falls back to its `dtype`;
    `gather_dtype` ("" | "f32" | "bf16") rounds the "moments" route's
    gather. Every output is float32.
    """

    NAME = "dgcnn"

    def __init__(self, num_classes: int = 10, k: int = 20,
                 dropout: float = 0.5, density_num_cls: int = 16,
                 pergroup: float = 2.0, knn_backend: str = "auto",
                 head_dtype: str = "f32", compute_dtype: str = "f32",
                 gather_dtype: str = "", edge_impl: str = "auto"):
        super().__init__()
        dt = parse_dtype(compute_dtype, "compute_dtype")
        hdt = parse_dtype(head_dtype, "head_dtype", allow_empty=True) or dt
        gdt = parse_dtype(gather_dtype, "gather_dtype", allow_empty=True)
        if edge_impl not in EDGE_IMPLS:
            raise ValueError(f"edge_impl must be one of {EDGE_IMPLS}, got "
                             f"{edge_impl!r}")
        self.config = {"k": k, "dropout": dropout,
                       "density_num_cls": density_num_cls,
                       "pergroup": pergroup, "head_dtype": head_dtype,
                       "compute_dtype": compute_dtype,
                       "gather_dtype": gather_dtype, "edge_impl": edge_impl}
        self.k = k
        self.knn_backend = knn_backend
        self.edge_impl = edge_impl
        self.dtype, self.head_dtype = dt, hdt
        self.input_transform_net = set_compute_dtype(TransformNet(3), dt)
        self.conv1 = EdgeConvM(3, 64, k, knn_backend, dt, gdt)
        self.conv2 = EdgeConvM(64, 64, k, knn_backend, dt, gdt)
        self.conv3 = EdgeConvM(64, 128, k, knn_backend, dt, gdt)
        self.conv4 = EdgeConvM(128, 256, k, knn_backend, dt, gdt)
        self.conv5 = set_compute_dtype(PointwiseConv(512, 1024, 1, False), dt)
        self.bn5 = nn.BatchNorm1d(1024)
        self.C = set_compute_dtype(Classifier(1024, num_classes, dropout), dt)
        self.DefRec = PointMLPHead(1536, 3, dropout)
        self.Norm_pred = PointMLPHead(1536, 3, dropout)
        self.Rec_scan = PointMLPHead(1536, 3, dropout)
        self.Density_cls = DensityHead(1536, density_num_cls, pergroup,
                                       dropout)
        for head in (self.DefRec, self.Norm_pred, self.Rec_scan,
                     self.Density_cls):
            set_compute_dtype(head, hdt)

    def edge_routes(self, n: int, device: str | torch.device
                    ) -> tuple[str, ...]:
        """The route of each EdgeConv layer for clouds of `n` points on
        `device`: `edge_impl`, or for "auto" the calibration's winner at
        the layer's (n, output width) (`utils.chipcal.edge_impl`)."""
        convs = (self.conv1, self.conv2, self.conv3, self.conv4)
        if self.edge_impl != "auto":
            return (self.edge_impl,) * len(convs)
        return tuple(chipcal.edge_impl(n, conv.cout, device)
                     for conv in convs)

    def forward(self, x: torch.Tensor, heads: tuple[str, ...] = (),
                generator: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
        """x [B, N, 3] -> dict with "cls" [B, num_classes], "feat"
        [B, 1024] and the per-point heads asked for, all float32. In train
        mode with dropout, the masks come from `generator` (on x's
        device)."""
        check_heads(heads, HEADS, self.NAME)
        idx = knn_indices(x.detach(), self.k, backend=self.knn_backend)
        T = self.input_transform_net(edge_features(x, idx))
        # The reference applies T @ x_col; channels-last that is x_row @ T^T.
        x = torch.einsum("bnc,bdc->bnd", x, T)
        if self.dtype is not None:
            x = x.to(self.dtype)

        r1, r2, r3, r4 = self.edge_routes(x.shape[1], x.device)
        x1 = self.conv1(x, r1)
        x2 = self.conv2(x1, r2)
        x3 = self.conv3(x2, r3)
        x4 = self.conv4(x3, r4)
        x_cat = torch.cat([x1, x2, x3, x4], dim=-1)  # [B, N, 512]
        x5 = leaky_relu(batch_norm(self.bn5, self.conv5(x_cat)))
        x5 = x5.amax(1)  # global feature [B, 1024]

        out = {"feat": x5.float(), "cls": self.C(x5, generator)}
        if not heads:
            return out
        pp = (x_cat, x5)  # the heads' input, concat [x_cat | x5] implied
        if self.head_dtype is not None:
            pp = (x_cat.to(self.head_dtype), x5.to(self.head_dtype))
        if "defrec" in heads:
            out["defrec"] = self.DefRec(pp, generator)
        if "normal" in heads:
            out["normal"] = self.Norm_pred(pp, generator)
        if "scan" in heads:
            out["scan"] = self.Rec_scan(pp, generator)
        if "density" in heads:
            out["density"], out["density_mse"] = self.Density_cls(
                pp, generator)
        return out
