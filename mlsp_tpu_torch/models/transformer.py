"""Point Transformer: a group-token ViT encoder with the classifier and
DefRec heads (counterpart of `mlsp_tpu/models/transformer.py`; the
reference's `PointTransformer`, `PointDA/Models.py:289-531`).

  FPS centers (K4 on the card) + cross-set kNN neighbourhoods, centred
  -> mini-PointNet group encoder -> reduce_dim -> [CLS] + learned pos
  embed, re-added before every block -> pre-LN ViT blocks -> final
  LayerNorm -> classifier on [cls ; max over tokens]
  -> DefRec: 3-NN inverse-distance propagation of the final-norm taps of
     blocks `fetch_idx` back to all N points, then the per-point head.

Parameter names are the reference's state_dict (what
`mlsp_tpu.utils.torch_export.export_point_transformer` emits), plus what
that export leaves out: the q/k/v biases (`blocks.blocks.{i}.attn.qkv.bias`,
which flax's attention has and the reference's lacks) and the DefRec head
(`DefRec.*`, which replaces the reference's CUDA propagation pyramid).

Where the math follows JAX and not the reference's torch code, because
the JAX package is the reference here: GELU is the tanh approximation
(flax `nn.gelu`), LayerNorm's epsilon is 1e-6, the attention has q/k/v
biases and scales the query by 1/sqrt(D/H) (flax
`MultiHeadDotProductAttention`), and the group encoder's concat convs
run as the sum of two matmuls, [global | h] split (`GroupEncoder`).
Attention and every dense layer are plain PyTorch in float32; the JAX
package runs them outside any Pallas kernel too.
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
    dropout,
)
from mlsp_tpu_torch.ops.fps import fps, fps_gather
from mlsp_tpu_torch.ops.knn import knn_gather, knn_indices
from mlsp_tpu_torch.ops.pairwise import pairwise_sqdist
from mlsp_tpu_torch.parallel.mesh import split_points

HEADS = ("defrec",)
LN_EPS = 1e-6  # flax nn.LayerNorm


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.gelu`: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def group_points_knn(xyz: torch.Tensor, num_group: int, group_size: int,
                     start_idx: torch.Tensor, backend: str = "auto"):
    """FPS centers and their kNN neighbourhoods in xyz, centred
    (`Group.forward`). Returns (neighborhood [B, G, M, 3], centers
    [B, G, 3])."""
    idx = fps(xyz.detach(), num_group, start_idx, backend=backend)
    centers = fps_gather(xyz, idx)
    nidx = knn_indices(centers.detach(), group_size, y=xyz.detach(),
                       backend=backend)
    return knn_gather(xyz, nidx) - centers[:, :, None, :], centers


def feature_propagation(xyz_dst: torch.Tensor, xyz_src: torch.Tensor,
                        feats_src: torch.Tensor, k: int = 3) -> torch.Tensor:
    """3-NN inverse-distance interpolation of feats_src [B, S, C] at
    xyz_src [B, S, 3] onto xyz_dst [B, N, 3] -> [B, N, C]; k = min(k, S),
    ties to the lower index (a stable sort, as `lax.top_k`), weights
    1 / (d + 1e-8) normalised. Under an active points mesh the rows of
    xyz_dst are split over the points group (`parallel.split_points`)."""
    k = min(k, xyz_src.shape[1])

    def rows(dst, src, feats):
        d = pairwise_sqdist(dst, src)  # [B, M, S]
        dk, idx = torch.sort(d, dim=-1, stable=True)
        dk, idx = dk[..., :k], idx[..., :k]
        w = 1.0 / (dk + 1e-8)
        w = w / w.sum(-1, keepdim=True)
        return (knn_gather(feats, idx) * w[..., None]).sum(2)

    return split_points(rows, xyz_dst, xyz_src, feats_src)


def _conv_stage(cin: int, cmid: int, cout: int) -> nn.ModuleList:
    """The reference's [Conv1d, BN, ReLU, Conv1d] (indices 0, 1, 3)."""
    return nn.ModuleList([PointwiseConv(cin, cmid, 1, True),
                          nn.BatchNorm1d(cmid), nn.Identity(),
                          PointwiseConv(cmid, cout, 1, True)])


class GroupEncoder(nn.Module):
    """Mini-PointNet group embedder (`Encoder`, `model_utils.py:292-336`):
    first_conv 3 -> 128 -> 256, add_conv1 [global | h] 512 -> 512 -> 256,
    second_conv [global | h] 512 -> 512 -> dim, max per group."""

    def __init__(self, dim: int = 256):
        super().__init__()
        self.first_conv = _conv_stage(3, 128, 256)
        self.add_conv1 = _conv_stage(512, 512, 256)
        self.second_conv = _conv_stage(512, 512, dim)

    @staticmethod
    def _stage(stage: nn.ModuleList, h: torch.Tensor) -> torch.Tensor:
        g = h.amax(-2, keepdim=True)  # [B, G, 1, 256]
        w = stage[0].weight.flatten(1)
        c = g.shape[-1]
        z = F.linear(g, w[:, :c], stage[0].bias) + F.linear(h, w[:, c:])
        return stage[3](F.relu(batch_norm(stage[1], z)))

    def forward(self, neigh: torch.Tensor) -> torch.Tensor:
        fc = self.first_conv
        h = fc[3](F.relu(batch_norm(fc[1], fc[0](neigh))))
        h = self._stage(self.add_conv1, h)
        return self._stage(self.second_conv, h).amax(-2)  # [B, G, dim]


class Attention(nn.Module):
    """Multi-head self-attention as flax's: q, k, v from `qkv` (rows [q;
    k; v], each head-major), the query scaled by 1/sqrt(D/H), softmax
    over keys, `proj` out."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        q, k, v = self.qkv(x).reshape(B, T, 3, self.heads, -1).unbind(2)
        q = q / math.sqrt(q.shape[-1])
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return self.proj(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, D))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-LN ViT block (`model_utils.py:201-266`); no dropout (the JAX
    block's rate is 0)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class Blocks(nn.Module):
    """The reference's `TransformerEncoder` (its `blocks` list)."""

    def __init__(self, dim: int, depth: int, heads: int):
        super().__init__()
        self.blocks = nn.ModuleList(Block(dim, heads) for _ in range(depth))


class PointTransformer(nn.Module):
    """trans_dim 384, depth 12, 6 heads, 64 groups x 32 points, a 256-wide
    group encoder (`PointDA/config/PointTransformer.yaml`); the DefRec
    head propagates the taps of blocks `fetch_idx`.

    `knn_backend` picks FPS's path ("auto": K4 for CUDA tensors; "torch":
    the plain loop anywhere); the cross-set kNN is plain everywhere. FPS
    starts at point 0 unless `forward` gets `rng_start` [B]."""

    NAME = "point_transformer"

    def __init__(self, num_classes: int = 10, trans_dim: int = 384,
                 depth: int = 12, heads: int = 6, num_group: int = 64,
                 group_size: int = 32, encoder_dims: int = 256,
                 dropout: float = 0.5, fetch_idx=(3, 7, 11),
                 knn_backend: str = "auto"):
        super().__init__()
        fetch_idx = tuple(fetch_idx)
        if not fetch_idx or not all(0 <= i < depth for i in fetch_idx):
            raise ValueError(f"fetch_idx {fetch_idx} must name blocks of "
                             f"0..{depth - 1}")
        self.config = {"trans_dim": trans_dim, "depth": depth, "heads": heads,
                       "num_group": num_group, "group_size": group_size,
                       "encoder_dims": encoder_dims, "dropout": dropout,
                       "fetch_idx": list(fetch_idx)}
        self.num_group, self.group_size = num_group, group_size
        self.fetch_idx, self.p = fetch_idx, dropout
        self.knn_backend = knn_backend
        D = trans_dim
        self.encoder = GroupEncoder(encoder_dims)
        self.reduce_dim = nn.Linear(encoder_dims, D)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.cls_pos = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.ModuleList([nn.Linear(3, 128), nn.Identity(),
                                        nn.Linear(128, D)])
        self.blocks = Blocks(D, depth, heads)
        self.norm = nn.LayerNorm(D, eps=LN_EPS)
        self.cls_head_finetune = nn.ModuleList([
            nn.Linear(2 * D, 256), nn.Identity(), nn.Identity(),
            nn.Linear(256, num_classes)])
        self.DefRec = PointMLPHead(len(fetch_idx) * D + 2 * D, 3, dropout)

    @torch.no_grad()
    def init_tokens(self, generator: torch.Generator) -> None:
        """flax's truncated_normal(0.02): cut at two standard deviations."""
        for t in (self.cls_token, self.cls_pos):
            nn.init.trunc_normal_(t, 0.0, 0.02, -0.04, 0.04,
                                  generator=generator)

    def forward(self, x: torch.Tensor, heads: tuple[str, ...] = (),
                generator: torch.Generator | None = None, rng_start=None
                ) -> dict[str, torch.Tensor]:
        """x [B, N, 3] -> {"feat" [B, 2D], "cls"[, "defrec" [B, N, 3]]}."""
        check_heads(heads, HEADS, self.NAME)
        B = x.shape[0]
        start = (torch.zeros(B, dtype=torch.int64, device=x.device)
                 if rng_start is None else rng_start)
        neigh, centers = group_points_knn(x, self.num_group, self.group_size,
                                          start, self.knn_backend)
        tokens = self.reduce_dim(self.encoder(neigh))  # [B, G, D]
        ch = self.cls_head_finetune
        return token_outputs(
            self, x, tokens, centers, heads, generator,
            lambda feat: ch[3](dropout(F.relu(ch[0](feat)), self.p,
                                       self.training, generator)))


def token_outputs(m: nn.Module, x: torch.Tensor, tokens: torch.Tensor,
                  centers: torch.Tensor, heads: tuple[str, ...],
                  generator: torch.Generator | None, cls_head
                  ) -> dict[str, torch.Tensor]:
    """What PointTransformer and Point-ViT share after the group embedder:
    [CLS] + tokens [B, G, D] with the pos embed of `centers` re-added
    before every block of `m.blocks`, the final LayerNorm `m.norm`,
    "feat" = [cls ; max over tokens], "cls" = cls_head(feat) and, with
    "defrec" in heads, the DefRec head on the 3-NN propagation of the
    final-norm taps of blocks `m.fetch_idx` (the same LayerNorm)."""
    B = x.shape[0]
    pe = m.pos_embed
    pos = pe[2](gelu(pe[0](centers)))
    D = tokens.shape[-1]
    h = torch.cat([m.cls_token.expand(B, 1, D), tokens], dim=1)
    p = torch.cat([m.cls_pos.expand(B, 1, D), pos], dim=1)
    taps = []
    for i, blk in enumerate(m.blocks.blocks):
        h = blk(h + p)  # the pos embed re-added before every block
        if i in m.fetch_idx:
            taps.append(h)
    h = m.norm(h)
    feat = torch.cat([h[:, 0], h[:, 1:].amax(1)], dim=-1)
    out = {"feat": feat, "cls": cls_head(feat)}
    if "defrec" in heads:
        tap_feats = torch.cat([m.norm(t)[:, 1:] for t in taps], dim=-1)
        per_pt = feature_propagation(x, centers, tap_feats)  # [B, N, 3D]
        out["defrec"] = m.DefRec((per_pt, feat), generator)
    return out
