"""The Hengshuang Point Transformer family: vector attention over kNN
neighbourhoods (counterpart of `mlsp_tpu/models/hengshuang.py`; the
reference's `PointDA/hengshuang_transformer/`).

  * `HengshuangTransformer` (`PointTransformerCls` with the
    `PointTransformerDef` DefRec branch): backbone, mean-pooled classifier;
    the DefRec head decodes back to every point through the U-Net decoder.
  * `HengshuangSeg` (`PointTransformerSeg`): the same backbone and
    decoder, per-point logits from `fc3`; it carries the DefRec head too,
    so that it can drive the PointSegDA trainer's DefRec branch.

Vector attention (per point i over its k nearest j, k = min(16, N)):
  q_i, k_j, v_j = linear(x);  delta_ij = mlp(p_i - p_j)
  w_ij = softmax_j(mlp_gamma(q_i - k_j + delta_ij) / sqrt(d_model))
  y_i  = sum_j w_ij (v_j + delta_ij)

Kernels: every vector attention builds a self-kNN graph of its points
through `ops.knn.knn_indices` (on the card the K1 kernel) and every
transition down samples with `ops.fps.fps` (K4), so a backbone launches K1
nblocks + 1 and K4 nblocks times and the decoder K1 nblocks + 1 more. The
transition down's grouping (a cross-set kNN) and the decoder's 3-NN
interpolation are plain PyTorch, as the JAX package runs them on XLA.

Parameter names are the reference's state_dict (what
`mlsp_tpu.utils.torch_export.export_hengshuang` emits); `HengshuangSeg`
adds its `DefRec.*`, which the reference's seg model lacks. `d_model` is
the reference YAML's `transformer_dim` (published: 512; the trainer's
`--transformer_dim`, `models.model_kwargs`).

Tracing (`utils.profiling`): each vector attention, transition down and
transition up runs in its span ("vector_attention", "transition_down",
"transition_up"), so that a profiled eager step puts each kernel on its
stage.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mlsp_tpu_torch.models.layers import (
    PointMLPHead,
    PointwiseConv,
    batch_norm,
    check_heads,
)
from mlsp_tpu_torch.models.transformer import feature_propagation
from mlsp_tpu_torch.ops.fps import fps, fps_gather
from mlsp_tpu_torch.ops.grouping import group_points
from mlsp_tpu_torch.ops.knn import knn_gather, knn_indices
from mlsp_tpu_torch.utils.profiling import span


def _mlp2(cin: int, cmid: int, cout: int) -> nn.ModuleList:
    """The reference's [Linear, ReLU, Linear] (indices 0 and 2)."""
    return nn.ModuleList([nn.Linear(cin, cmid), nn.Identity(),
                          nn.Linear(cmid, cout)])


def _run_mlp(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    """[Linear, ReLU, Linear(, ReLU, Linear)] at the even indices."""
    lins = list(layers)[::2]
    for lin in lins[:-1]:
        x = F.relu(lin(x))
    return lins[-1](x)


class VectorAttention(nn.Module):
    """`TransformerBlock` (`hengshuang_transformer/transformer.py:7-44`):
    fc1, w_qs, w_ks, w_vs, fc_delta, fc_gamma, fc2 and the residual."""

    def __init__(self, cin: int, d_model: int = 128, k: int = 16,
                 knn_backend: str = "auto"):
        super().__init__()
        self.k, self.knn_backend = k, knn_backend
        self.fc1 = nn.Linear(cin, d_model)
        self.w_qs = nn.Linear(d_model, d_model, bias=False)
        self.w_ks = nn.Linear(d_model, d_model, bias=False)
        self.w_vs = nn.Linear(d_model, d_model, bias=False)
        self.fc_delta = _mlp2(3, d_model, d_model)
        self.fc_gamma = _mlp2(d_model, d_model, d_model)
        self.fc2 = nn.Linear(d_model, cin)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        with span("vector_attention"):
            x = self.fc1(feats)
            q, kf, vf = self.w_qs(x), self.w_ks(x), self.w_vs(x)
            xyz_c = xyz.detach()
            idx = knn_indices(xyz_c, min(self.k, xyz.shape[1]),
                              backend=self.knn_backend)
            rel = xyz_c[:, :, None, :] - knn_gather(xyz_c, idx)  # p_i - p_j
            delta = _run_mlp(self.fc_delta, rel)
            gamma = _run_mlp(self.fc_gamma,
                             q[:, :, None, :] - knn_gather(kf, idx) + delta)
            attn = torch.softmax(gamma / math.sqrt(q.shape[-1]), dim=-2)
            y = (attn * (knn_gather(vf, idx) + delta)).sum(-2)
            return self.fc2(y) + feats


class SetAbstractionKNN(nn.Module):
    """The reference's `sa` of a transition down: two [1x1 Conv2d, BN,
    ReLU] stages (`mlp_convs`, `mlp_bns`) over grouped [xyz - c | feats]."""

    def __init__(self, cin: int, channels: int):
        super().__init__()
        self.mlp_convs = nn.ModuleList([
            PointwiseConv(cin, channels, 2, True),
            PointwiseConv(channels, channels, 2, True)])
        self.mlp_bns = nn.ModuleList([nn.BatchNorm1d(channels),
                                      nn.BatchNorm1d(channels)])

    def forward(self, g: torch.Tensor) -> torch.Tensor:
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            g = F.relu(batch_norm(bn, conv(g)))
        return g.amax(-2)


class TransitionDown(nn.Module):
    """FPS (from point 0) + a cross-set kNN grouping + the `sa` MLP."""

    def __init__(self, k: int, cin: int, channels: int, knn_backend: str):
        super().__init__()
        self.k, self.knn_backend = k, knn_backend
        self.sa = SetAbstractionKNN(cin + 3, channels)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor, npoint: int):
        with span("transition_down"):
            xyz_c = xyz.detach()
            start = torch.zeros(xyz.shape[0], dtype=torch.int64,
                                device=xyz.device)
            centers = fps_gather(xyz_c, fps(xyz_c, npoint, start,
                                            backend=self.knn_backend))
            nidx = knn_indices(centers, min(self.k, xyz.shape[1]), y=xyz_c,
                               backend=self.knn_backend)
            return centers, self.sa(group_points(xyz_c, feats, centers,
                                                 nidx))


class TransitionUp(nn.Module):
    """`TransitionUp` (`hengshuang_model.py:16-47`): both scales projected
    to `dim_out` (Linear, BN, ReLU: `fc1` the coarse, `fc2` the fine), the
    coarse one 3-NN interpolated onto the fine points, summed."""

    def __init__(self, dim_coarse: int, dim_out: int):
        super().__init__()
        self.fc1 = nn.ModuleList([nn.Linear(dim_coarse, dim_out),
                                  nn.Identity(), nn.BatchNorm1d(dim_out)])
        self.fc2 = nn.ModuleList([nn.Linear(dim_out, dim_out), nn.Identity(),
                                  nn.BatchNorm1d(dim_out)])

    @staticmethod
    def _proj(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
        return F.relu(batch_norm(layers[2], layers[0](x)))

    def forward(self, xyz_c, f_c, xyz_f, f_f):
        with span("transition_up"):
            return (feature_propagation(xyz_f, xyz_c,
                                        self._proj(self.fc1, f_c))
                    + self._proj(self.fc2, f_f))


class Backbone(nn.Module):
    """`Backbone` (`hengshuang_model.py:49-77`): a per-point MLP and a
    vector attention, then `nblocks` x [transition down to N // 4^(i+1)
    points (at least 1) -> vector attention]. Returns (xyz, feats) per
    scale, [0] the whole cloud at base_dim channels."""

    def __init__(self, nblocks: int, nneighbor: int, d_model: int,
                 base_dim: int, knn_backend: str):
        super().__init__()
        self.fc1 = _mlp2(3, base_dim, base_dim)
        self.transformer1 = VectorAttention(base_dim, d_model, nneighbor,
                                            knn_backend)
        self.transition_downs = nn.ModuleList(
            TransitionDown(nneighbor, base_dim * 2 ** i,
                           base_dim * 2 ** (i + 1), knn_backend)
            for i in range(nblocks))
        self.transformers = nn.ModuleList(
            VectorAttention(base_dim * 2 ** (i + 1), d_model, nneighbor,
                            knn_backend) for i in range(nblocks))

    def forward(self, x: torch.Tensor) -> list:
        N = x.shape[1]
        feats = self.transformer1(x, _run_mlp(self.fc1, x))
        xyz, taps = x, [(x, feats)]
        for i, (td, va) in enumerate(zip(self.transition_downs,
                                         self.transformers)):
            xyz, feats = td(xyz, feats, max(N // 4 ** (i + 1), 1))
            feats = va(xyz, feats)
            taps.append((xyz, feats))
        return taps


class _Decoded(nn.Module):
    """The backbone and the U-Net decoder (`hengshuang_model.py:104-139,
    145-206`) under the reference's top-level names: `fc2` (Linear/ReLU,
    no BN), `transformer2` at the coarsest scale, then per level a
    `transition_ups` and a `transformers` block back to all points. `k`
    is the neighbours a point attends over (`nneighbor`), as DGCNN's."""

    def __init__(self, nblocks: int, nneighbor: int, d_model: int,
                 base_dim: int, knn_backend: str):
        super().__init__()
        self.k = nneighbor
        self.backbone = Backbone(nblocks, nneighbor, d_model, base_dim,
                                 knn_backend)
        top = base_dim * 2 ** nblocks
        self.fc2 = nn.ModuleList([nn.Linear(top, 512), nn.Identity(),
                                  nn.Linear(512, 512), nn.Identity(),
                                  nn.Linear(512, top)])
        self.transformer2 = VectorAttention(top, d_model, nneighbor,
                                            knn_backend)
        levels = list(reversed(range(nblocks)))
        self.transition_ups = nn.ModuleList(
            TransitionUp(base_dim * 2 ** (i + 1), base_dim * 2 ** i)
            for i in levels)
        self.transformers = nn.ModuleList(
            VectorAttention(base_dim * 2 ** i, d_model, nneighbor,
                            knn_backend) for i in levels)

    def decode(self, taps: list) -> torch.Tensor:
        xyz, feats = taps[-1]
        feats = self.transformer2(xyz, _run_mlp(self.fc2, feats))
        for j, (up, va) in enumerate(zip(self.transition_ups,
                                         self.transformers)):
            xyz_f, f_f = taps[len(taps) - 2 - j]
            feats = va(xyz_f, up(xyz, feats, xyz_f, f_f))
            xyz = xyz_f
        return feats  # [B, N, base_dim]


class HengshuangTransformer(_Decoded):
    """`PointTransformerCls` + the `PointTransformerDef` DefRec branch:
    nblocks 4, 16 neighbours, d_model 128, base_dim 32; classifier on the
    mean of the coarsest features; the DefRec head on [decoded per-point
    base_dim | pooled]. `knn_backend` picks the kNN and FPS paths ("auto":
    the kernels for CUDA tensors; "torch": the plain versions)."""

    NAME = "hengshuang"
    HEADS = ("defrec",)

    def __init__(self, num_classes: int = 10, nblocks: int = 4,
                 nneighbor: int = 16, d_model: int = 128, base_dim: int = 32,
                 dropout: float = 0.5, knn_backend: str = "auto"):
        super().__init__(nblocks, nneighbor, d_model, base_dim, knn_backend)
        self.config = {"nblocks": nblocks, "nneighbor": nneighbor,
                       "d_model": d_model, "base_dim": base_dim,
                       "dropout": dropout}
        top = base_dim * 2 ** nblocks
        self.cls_head_finetune = nn.ModuleList([
            nn.Linear(top, 256), nn.Identity(), nn.Linear(256, 64),
            nn.Identity(), nn.Linear(64, num_classes)])
        self.DefRec = PointMLPHead(base_dim + top, 3, dropout)

    def forward(self, x: torch.Tensor, heads: tuple[str, ...] = (),
                generator: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
        """x [B, N, 3] -> {"feat" [B, 32·2^nblocks], "cls"[, "defrec"
        [B, N, 3]]}."""
        check_heads(heads, self.HEADS, self.NAME)
        taps = self.backbone(x)
        pooled = taps[-1][1].mean(1)
        out = {"feat": pooled,
               "cls": _run_mlp(self.cls_head_finetune, pooled)}
        if "defrec" in heads:
            out["defrec"] = self.DefRec((self.decode(taps), pooled), generator)
        return out


class HengshuangSeg(_Decoded):
    """`PointTransformerSeg` with the DefRec head: per-point logits from
    `fc3` (Linear/ReLU 64, 64, classes) on the decoded features."""

    NAME = "hengshuang_seg"
    HEADS = ("seg", "defrec")

    def __init__(self, num_classes: int = 8, nblocks: int = 4,
                 nneighbor: int = 16, d_model: int = 128, base_dim: int = 32,
                 dropout: float = 0.5, knn_backend: str = "auto"):
        super().__init__(nblocks, nneighbor, d_model, base_dim, knn_backend)
        self.config = {"nblocks": nblocks, "nneighbor": nneighbor,
                       "d_model": d_model, "base_dim": base_dim,
                       "dropout": dropout}
        self.fc3 = nn.ModuleList([
            nn.Linear(base_dim, 64), nn.Identity(), nn.Linear(64, 64),
            nn.Identity(), nn.Linear(64, num_classes)])
        self.DefRec = PointMLPHead(base_dim + base_dim * 2 ** nblocks, 3,
                                   dropout)

    def forward(self, x: torch.Tensor, heads: tuple[str, ...] = ("seg",),
                generator: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
        """x [B, N, 3] -> {"feat" [B, 32·2^nblocks]} and the heads asked
        for: "seg" [B, N, num_classes] (also with no heads, as in JAX),
        "defrec" [B, N, 3]."""
        check_heads(heads, self.HEADS, self.NAME)
        taps = self.backbone(x)
        pooled = taps[-1][1].mean(1)
        per_pt = self.decode(taps)
        out = {"feat": pooled}
        if not heads or "seg" in heads:
            out["seg"] = _run_mlp(self.fc3, per_pt)
        if "defrec" in heads:
            out["defrec"] = self.DefRec((per_pt, pooled), generator)
        return out
