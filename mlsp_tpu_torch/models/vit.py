"""Point-ViT (counterpart of `mlsp_tpu/models/vit.py`, the JAX package's
working form of the reference's bit-rotted `ViT`, `PointDA/vit_utils.py`).

  FPS centers (K4 on the card) + cross-set kNN neighbourhoods, centred
  -> one of four group embedders (`encoder_type`) -> reduce_dim
  -> [CLS] + learned pos embed, re-added before every block -> pre-LN ViT
  blocks -> final LayerNorm -> the ViT head (Dense 256, ReLU, dropout,
  Dense C) on [cls ; max over tokens]
  -> DefRec: 3-NN propagation of the final-norm taps of blocks
     `fetch_idx` (the same LayerNorm) back to all N points.

The group embedders:
  * "relative" (`RelativeGroupEncoder`): a mini-PointNet over the
    centre-relative coordinates, which re-enters both 515-wide stages;
    `use_absolute` feeds [rel | rel + centre] to the first Dense;
  * "pointnet": PointTransformer's `GroupEncoder`;
  * "dgcnn" (`DgcnnGroupEncoder`): a DGCNN per group, the groups folded
    into the batch: a self-kNN (K1 on the card) at [B·G, M, C] five times
    per forward, a `dgcnn`-mode T-net and four gather-form `EdgeConv`s;
  * "pointnet_tnet" (`PointnetGroupEncoder`): a PointNet per group with
    two `pointnet`-mode T-nets.

Parameter names. The parts shared with PointTransformer keep its
(reference) names: `encoder.*` (the "pointnet" embedder), `reduce_dim`,
`cls_token`, `cls_pos`, `pos_embed.{0,2}`, `blocks.blocks.{i}.*`, `norm`,
`DefRec.*`, and the T-nets keep `TransformNet`'s. Every other part has no
reference layout and is named by its flax path: the embedders
`RelativeGroupEncoder_0.{Dense_j, BatchNorm_j}`,
`DgcnnGroupEncoder_0.{TransformNet_0, EdgeConv_i.{w_diff, w_center,
BatchNorm_0}, DenseBN_0}`, `PointnetGroupEncoder_0.{TransformNet_0,
trans_net2, DenseBN_j}`, and the head `head_fc1`, `head_fc2`
(`utils/jax_weights.py::vit_state_dict_from_jax`).

Attention, the Denses and the gather EdgeConv are plain PyTorch in
float32, as JAX runs them outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mlsp_tpu_torch.models.dgcnn import EdgeConv
from mlsp_tpu_torch.models.layers import (
    FlaxDenseBN,
    PointMLPHead,
    TransformNet,
    batch_norm,
    check_heads,
    dropout,
)
from mlsp_tpu_torch.models.transformer import (
    LN_EPS,
    Blocks,
    GroupEncoder,
    group_points_knn,
    token_outputs,
)
from mlsp_tpu_torch.ops.knn import edge_features, knn_indices

HEADS = ("defrec",)
# encoder_type -> the attribute (and state_dict prefix) of its embedder
ENCODERS = {"relative": "RelativeGroupEncoder_0", "pointnet": "encoder",
            "dgcnn": "DgcnnGroupEncoder_0",
            "pointnet_tnet": "PointnetGroupEncoder_0"}


class RelativeGroupEncoder(nn.Module):
    """Dense 128, BN, ReLU, Dense 256, then two stages, each a 515-wide
    Dense over [max over the group | h | rel] written as the sum of three
    Denses (Dense_{4s-2} the global max, with the bias; Dense_{4s-1} h;
    Dense_{4s} rel), BatchNorm_s, ReLU and an out Dense (256, then dim);
    a max per group."""

    def __init__(self, dim: int = 384, use_absolute: bool = False):
        super().__init__()
        self.use_absolute = use_absolute
        self.Dense_0 = nn.Linear(6 if use_absolute else 3, 128)
        self.BatchNorm_0 = nn.BatchNorm1d(128)
        self.Dense_1 = nn.Linear(128, 256)
        for s, out in ((1, 256), (2, dim)):
            j = 4 * s - 2
            setattr(self, f"Dense_{j}", nn.Linear(256, 515))
            setattr(self, f"Dense_{j + 1}", nn.Linear(256, 515, bias=False))
            setattr(self, f"Dense_{j + 2}", nn.Linear(3, 515, bias=False))
            setattr(self, f"BatchNorm_{s}", nn.BatchNorm1d(515))
            setattr(self, f"Dense_{j + 3}", nn.Linear(515, out))

    def forward(self, rel: torch.Tensor, centers: torch.Tensor
                ) -> torch.Tensor:
        """rel [B, G, M, 3], centers [B, G, 3] -> [B, G, dim]."""
        x = rel
        if self.use_absolute:
            x = torch.cat([rel, rel + centers[:, :, None, :]], dim=-1)
        h = F.relu(batch_norm(self.BatchNorm_0, self.Dense_0(x)))
        h = self.Dense_1(h)
        for s in (1, 2):
            d = [getattr(self, f"Dense_{4 * s - 2 + i}") for i in range(4)]
            z = d[0](h.amax(-2, keepdim=True)) + d[1](h) + d[2](rel)
            h = d[3](F.relu(batch_norm(getattr(self, f"BatchNorm_{s}"), z)))
        return h.amax(-2)


class DgcnnGroupEncoder(nn.Module):
    """A DGCNN per group, the groups folded into the batch: a `dgcnn`-mode
    T-net on the edge features of the k-graph (k = min(20, M)), applied as
    x T^T; four gather-form EdgeConvs 64/64/128/256, each on a fresh
    self-kNN of its input; a bias-free Dense to dim with BN and LeakyReLU
    over the 512-wide concat; a max per group."""

    def __init__(self, dim: int = 384, k: int = 20,
                 knn_backend: str = "auto"):
        super().__init__()
        self.k, self.knn_backend = k, knn_backend
        self.TransformNet_0 = TransformNet(3, "dgcnn")
        for i, (a, b) in enumerate(((3, 64), (64, 64), (64, 128),
                                    (128, 256))):
            setattr(self, f"EdgeConv_{i}", EdgeConv(a, b))
        self.DenseBN_0 = FlaxDenseBN(512, dim, "leakyrelu", bias=False)

    def forward(self, rel: torch.Tensor) -> torch.Tensor:
        B, G, M, _ = rel.shape
        x = rel.reshape(B * G, M, 3)
        k = min(self.k, M)

        def graph(t):
            return knn_indices(t.detach(), k, backend=self.knn_backend)

        T = self.TransformNet_0(edge_features(x, graph(x)))
        x = torch.einsum("bnc,bdc->bnd", x, T)  # the transposed apply
        feats = []
        for i in range(4):
            x = getattr(self, f"EdgeConv_{i}")(x, graph(x))
            feats.append(x)
        x = self.DenseBN_0(torch.cat(feats, dim=-1))
        return x.amax(-2).reshape(B, G, -1)


class PointnetGroupEncoder(nn.Module):
    """A PointNet per group, the groups folded into the batch: a 3x3
    T-net (x T), Denses 64, 64, a 64x64 T-net (`trans_net2`), Denses 64,
    128, dim (BN + ReLU each); a max per group."""

    def __init__(self, dim: int = 384):
        super().__init__()
        self.TransformNet_0 = TransformNet(3, "pointnet")
        self.DenseBN_0 = FlaxDenseBN(3, 64)
        self.DenseBN_1 = FlaxDenseBN(64, 64)
        self.trans_net2 = TransformNet(64, "pointnet")
        self.DenseBN_2 = FlaxDenseBN(64, 64)
        self.DenseBN_3 = FlaxDenseBN(64, 128)
        self.DenseBN_4 = FlaxDenseBN(128, dim)

    def forward(self, rel: torch.Tensor) -> torch.Tensor:
        B, G, M, _ = rel.shape
        x = rel.reshape(B * G, M, 3)
        x = torch.einsum("bnc,bcd->bnd", x, self.TransformNet_0(x))
        x2 = self.DenseBN_1(self.DenseBN_0(x))
        x = torch.einsum("bnc,bcd->bnd", x2, self.trans_net2(x2))
        x = self.DenseBN_4(self.DenseBN_3(self.DenseBN_2(x)))
        return x.amax(-2).reshape(B, G, -1)


class PointViT(nn.Module):
    """The JAX `PointViT` defaults: trans_dim 384, encoder_dims 384, depth
    12, 6 heads, 64 groups x 32 points, the "relative" embedder, taps of
    blocks (3, 7, 11).

    `knn_backend` picks the FPS's and the "dgcnn" embedder's kNN path
    ("auto": K4 and K1 for CUDA tensors; "torch": the plain versions
    anywhere); the cross-set kNN of the grouping is plain everywhere. FPS
    starts at point 0 unless `forward` gets `rng_start` [B]."""

    NAME = "vit"

    def __init__(self, num_classes: int = 10, trans_dim: int = 384,
                 encoder_dims: int = 384, depth: int = 12, heads: int = 6,
                 num_group: int = 64, group_size: int = 32,
                 dropout: float = 0.5, encoder_type: str = "relative",
                 use_absolute: bool = False, fetch_idx=(3, 7, 11),
                 knn_backend: str = "auto"):
        super().__init__()
        fetch_idx = tuple(fetch_idx)
        bad = [i for i in fetch_idx if i >= depth]
        if bad:
            raise ValueError(
                f"fetch_idx {bad} out of range for depth={depth}; "
                "set fetch_idx explicitly when reducing depth")
        if encoder_type not in ENCODERS:
            raise ValueError(f"unknown encoder_type {encoder_type!r}")
        self.config = {"trans_dim": trans_dim, "encoder_dims": encoder_dims,
                       "depth": depth, "heads": heads,
                       "num_group": num_group, "group_size": group_size,
                       "dropout": dropout, "encoder_type": encoder_type,
                       "use_absolute": use_absolute,
                       "fetch_idx": list(fetch_idx)}
        self.num_group, self.group_size = num_group, group_size
        self.fetch_idx, self.p = fetch_idx, dropout
        self.encoder_type, self.knn_backend = encoder_type, knn_backend
        E, D = encoder_dims, trans_dim
        setattr(self, ENCODERS[encoder_type], {
            "relative": lambda: RelativeGroupEncoder(E, use_absolute),
            "pointnet": lambda: GroupEncoder(E),
            "dgcnn": lambda: DgcnnGroupEncoder(E, knn_backend=knn_backend),
            "pointnet_tnet": lambda: PointnetGroupEncoder(E),
        }[encoder_type]())
        self.reduce_dim = nn.Linear(E, D)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.cls_pos = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.ModuleList([nn.Linear(3, 128), nn.Identity(),
                                        nn.Linear(128, D)])
        self.blocks = Blocks(D, depth, heads)
        self.norm = nn.LayerNorm(D, eps=LN_EPS)
        self.head_fc1 = nn.Linear(2 * D, 256)
        self.head_fc2 = nn.Linear(256, num_classes)
        self.DefRec = PointMLPHead(len(fetch_idx) * D + 2 * D, 3, dropout)

    @torch.no_grad()
    def init_tokens(self, generator: torch.Generator) -> None:
        """flax's inits: cls_token zeros, cls_pos a standard normal."""
        self.cls_token.zero_()
        self.cls_pos.normal_(0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor, heads: tuple[str, ...] = (),
                generator: torch.Generator | None = None, rng_start=None
                ) -> dict[str, torch.Tensor]:
        """x [B, N, 3] -> {"feat" [B, 2D], "cls"[, "defrec" [B, N, 3]]}."""
        check_heads(heads, HEADS, self.NAME)
        B = x.shape[0]
        start = (torch.zeros(B, dtype=torch.int64, device=x.device)
                 if rng_start is None else rng_start)
        rel, centers = group_points_knn(x, self.num_group, self.group_size,
                                        start, self.knn_backend)
        enc = getattr(self, ENCODERS[self.encoder_type])
        tokens = (enc(rel, centers) if self.encoder_type == "relative"
                  else enc(rel))
        return token_outputs(
            self, x, self.reduce_dim(tokens), centers, heads, generator,
            lambda feat: self.head_fc2(dropout(
                F.relu(self.head_fc1(feat)), self.p, self.training,
                generator)))
